"""Synthetic light-field scenes from a seed: the traffic of every cell.

Frozen copy of the scene model of ``mmlf_tpu_torch/data/synth.py``
(``generate_dataset`` and ``make_scene``): the same random draws from one
``np.random.Generator`` in the same order, so a seed gives the same
layered scenes (a textured background plane, feathered foreground layers,
front-to-back compositing, a multi-plane image).  The textures, alphas and
views are computed with torch on the given device (the numpy original
takes ~11 s a 512² scene on one core); only the views a caller asks for
are rendered.  Views are quantized to 8 bits as a PNG file holds them.
"""

from __future__ import annotations

import numpy as np
import torch

# row-major indices of the 9x9 grid that the loader's four cross-hair
# stacks read (horizontal, vertical, increasing and decreasing diagonal)
GRID = 9


def cross_indices(n: int = GRID):
    """The four stacks' grid indices, as the HCI loader picks them."""
    horizontal = [(n // 2) * n + i for i in range(n)]
    vertical = [(n // 2) + n * i for i in range(n)]
    increasing = [n - i - 1 + n * i for i in range(n)][::-1]
    decreasing = [i + n * i for i in range(n)]
    return horizontal, vertical, increasing, decreasing


def _box_blur(img: torch.Tensor, k: int) -> torch.Tensor:
    """The generator's circular separable box blur through cumsum."""
    size = img.shape[0]
    for axis in (0, 1):
        pad = torch.cat([img.narrow(axis, size - k, k), img,
                         img.narrow(axis, 0, k)], axis)
        cs = torch.cumsum(pad, axis)
        img = (cs.narrow(axis, 2 * k, size) - cs.narrow(axis, 0, size)) / \
            (2 * k)
    return img


def _texture(rng, size: int, dev, blur: int = 9) -> torch.Tensor:
    img = torch.from_numpy(rng.random((size, size, 3), dtype=np.float32))
    img = _box_blur(img.to(dev), blur)
    lo, hi = img.min(), img.max()
    return 0.1 + 0.8 * (img - lo) / torch.clamp(hi - lo, min=1e-6)


def _layer_alpha(rng, size: int, dev) -> torch.Tensor:
    alpha = torch.zeros((size, size), dtype=torch.float32, device=dev)
    y0, x0 = (int(v) for v in rng.integers(size // 8, size // 2, 2))
    bh, bw = (int(v) for v in rng.integers(size // 4, size // 2, 2))
    if rng.random() < 0.5:
        alpha[y0:y0 + bh, x0:x0 + bw] = 1.0
    else:
        ar = torch.arange(size, dtype=torch.float32, device=dev)
        yy, xx = ar[:, None], ar[None, :]
        cy, cx = y0 + bh / 2.0, x0 + bw / 2.0
        inside = ((yy - cy) / (bh / 2.0)) ** 2 + \
            ((xx - cx) / (bw / 2.0)) ** 2 <= 1.0
        alpha[inside] = 1.0
    return alpha


def _feather(alpha: torch.Tensor, width: int = 2) -> torch.Tensor:
    size = alpha.shape[0]
    a = alpha
    for axis in (0, 1):
        first_row = a.narrow(axis, 0, 1)
        last_row = a.narrow(axis, size - 1, 1)
        pad = torch.cat([first_row.expand_as(a.narrow(axis, 0, width)), a,
                         last_row.expand_as(a.narrow(axis, 0, width))], axis)
        cs = torch.cumsum(pad, axis)
        first = pad.narrow(axis, 0, size)
        a = (cs.narrow(axis, 2 * width, size) - cs.narrow(axis, 0, size)
             + first) / (2 * width + 1)
    return torch.clamp(a, 0.0, 1.0)


def roll_lerp(x: torch.Tensor, s: float, dim: int) -> torch.Tensor:
    """Sub-pixel circular shift along ``dim``: ``(1-α)·roll(x, s0) +
    α·roll(x, s1)`` with ``s0 = trunc(s)``, ``α = |s - s0|`` and
    ``s1 = s0 + copysign(1, s0)`` (the signed zero of trunc decides)."""
    s = np.float32(s)
    s0 = np.trunc(s)
    a = float(np.abs(s - s0))
    s1 = s0 + np.copysign(np.float32(1.0), s0)
    return (1.0 - a) * torch.roll(x, int(s0), dim) + \
        a * torch.roll(x, int(s1), dim)


def make_scene(rng, size: int, disp_bg: float, disp_fg: float, dev,
               views=None, extra_disps=()):
    """One scene: ``(views, gt, mpi)`` with ``views`` a dict from grid
    index to a ``(size, size, 3)`` uint8 tensor (only the indices in
    ``views``, default all 81), gt ``(size, size)`` and the MPI ``(K,
    size, size, 5)`` float32, all on ``dev``."""
    partial = sorted(float(x) for x in (disp_fg,) + tuple(extra_disps)
                     if float(x) > float(disp_bg))
    disps = [float(disp_bg)] + partial
    textures = [_texture(rng, size, dev) for _ in disps]
    alphas = [torch.ones((size, size), dtype=torch.float32, device=dev)] + \
        [_feather(_layer_alpha(rng, size, dev)) for _ in disps[1:]]

    comps = [None] * len(disps)
    trans = torch.ones((size, size), dtype=torch.float32, device=dev)
    for k in range(len(disps) - 1, -1, -1):
        comps[k] = alphas[k] * trans
        trans = trans * (1.0 - alphas[k])
    comp_stack = torch.stack(comps)
    gt = torch.tensor(disps, dtype=torch.float32,
                      device=dev)[comp_stack.argmax(0)]

    mpi = torch.zeros((len(disps), size, size, 5), dtype=torch.float32,
                      device=dev)
    for k, (d, t, c) in enumerate(zip(disps, textures, comps)):
        mpi[k, ..., :3] = t
        mpi[k, ..., 3] = c
        mpi[k, ..., 4] = d

    wanted = range(GRID * GRID) if views is None else sorted(set(views))
    out = {}
    cy = cx = GRID // 2
    for idx in wanted:
        dr, dc = idx // GRID - cy, idx % GRID - cx

        def shift(img, d):
            img = roll_lerp(img, -d * dr, 0)
            return roll_lerp(img, -d * dc, 1)

        img = shift(textures[0], disps[0])
        for d, t, a in zip(disps[1:], textures[1:], alphas[1:]):
            a_v = shift(a, d)[..., None]
            img = a_v * shift(t, d) + (1.0 - a_v) * img
        out[idx] = torch.round(torch.clamp(img, 0.0, 1.0) * 255.0).to(
            torch.uint8)
    return out, gt, mpi


def scene_draws(rng, disp_range: float, disp_center: float, layers: int):
    """The disparities ``generate_dataset`` draws for one scene before its
    ``make_scene``: ``(disp_bg, disp_fg, extra)``."""
    disp_bg = float(rng.uniform(-disp_range, 0.0)) + disp_center
    disp_fg = float(rng.uniform(0.0, disp_range)) + disp_center
    extra_lo = min(disp_bg - disp_center + 0.05, disp_range)
    extra = [float(rng.uniform(extra_lo, disp_range)) + disp_center
             for _ in range(max(0, layers - 2))]
    return disp_bg, disp_fg, extra


def generate(seed: int, scenes: int, size: int, dev, disp_range: float = 1.8,
             disp_center: float = 0.0, layers: int = 2, views=None):
    """``scenes`` scenes of ``generate_dataset(seed=seed)``'s sequence
    (``seed`` may also be a ``np.random.Generator``): a list of
    ``make_scene`` results."""
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(scenes):
        disp_bg, disp_fg, extra = scene_draws(rng, disp_range, disp_center,
                                              layers)
        out.append(make_scene(rng, size, disp_bg, disp_fg, dev, views,
                              extra))
    return out


def texture_mask(center: torch.Tensor, wsize: int = 23,
                 threshold: float = 0.02) -> torch.Tensor:
    """The loader's texture mask of a ``(H, W, 3)`` float centre view: 1
    where the mean absolute deviation over the zero-padded ``wsize``²
    neighbourhood and the colours is at least ``threshold``, with a
    ``wsize // 2`` margin of 0.  int32 ``(H, W)``."""
    h, w, c = center.shape
    r = wsize // 2
    padded = torch.nn.functional.pad(center.permute(2, 0, 1),
                                     (r, r, r, r)).permute(1, 2, 0)
    acc = torch.zeros((h, w), dtype=torch.float32, device=center.device)
    for dy in range(wsize):
        for dx in range(wsize):
            acc += torch.abs(padded[dy:dy + h, dx:dx + w] - center).sum(-1)
    mask = (acc / float(wsize * wsize * c) >= threshold).to(torch.int32)
    mask[:r] = 0
    mask[-r:] = 0
    mask[:, :r] = 0
    mask[:, -r:] = 0
    return mask


def stacks_of(views: dict, dtype=torch.float32):
    """The four ``(9, H, W, 3)`` stacks in [0, 1] of a scene's views, as
    the loader decodes 8-bit files."""
    return [torch.stack([views[i] for i in idx]).to(dtype) / 255.0
            for idx in cross_indices()]
