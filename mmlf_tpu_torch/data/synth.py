"""Synthetic light-field scene generator (numpy).

Renders HCI4D-layout scene directories (81 ``input_Cam*.png`` views,
``gt_disp_lowres.pfm``, ``gt_mpi_lowres.npz``) from a layered scene: a
textured background plane at one disparity and textured foreground patches
at others.  Views are rendered with the same sub-pixel circular-shift model
the EPI-Shift op inverts, and the MPI carries multimodal pixels at the
feathered occlusion boundaries.  For a seed it writes the same scenes as
``mmlf_tpu.data.synth``.

Usage: ``python -m mmlf_tpu_torch.data.synth OUT --scenes 1 --size 512``
"""

from __future__ import annotations

import os

import numpy as np

from ..utils import pfm
from ..utils.imgio import save_img
from .transforms import np_roll_lerp_views


def _texture(rng: np.random.Generator, size: int, blur: int = 9):
    """Smooth random RGB texture in [0.1, 0.9] so gradients carry signal."""
    img = rng.random((size, size, 3), dtype=np.float32)
    # cheap separable box blur via cumsum
    for axis in (0, 1):
        k = blur
        pad = np.concatenate([img.take(range(size - k, size), axis),
                              img, img.take(range(k), axis)], axis)
        cs = np.cumsum(pad, axis=axis, dtype=np.float32)
        img = (np.take(cs, range(2 * k, 2 * k + size), axis)
               - np.take(cs, range(size), axis)) / (2 * k)
    lo, hi = img.min(), img.max()
    return 0.1 + 0.8 * (img - lo) / max(hi - lo, 1e-6)


def _shift_img(img: np.ndarray, dy: float, dx: float) -> np.ndarray:
    """Sub-pixel circular shift of (H, W, C) content by (-dy, -dx)."""
    out = np_roll_lerp_views(img[None], np.float32([dy]), axis=-3)[0]
    out = np_roll_lerp_views(out[None], np.float32([dx]), axis=-2)[0]
    return out


def _layer_alpha(rng: np.random.Generator, size: int) -> np.ndarray:
    """Random box or ellipse occupancy mask covering ~1/16..1/4 of the
    image."""
    alpha = np.zeros((size, size), dtype=np.float32)
    y0, x0 = rng.integers(size // 8, size // 2, 2)
    bh, bw = rng.integers(size // 4, size // 2, 2)
    if rng.random() < 0.5:
        alpha[y0:y0 + bh, x0:x0 + bw] = 1.0
    else:
        yy, xx = np.mgrid[0:size, 0:size].astype(np.float32)
        cy, cx = y0 + bh / 2.0, x0 + bw / 2.0
        alpha[((yy - cy) / (bh / 2.0)) ** 2
              + ((xx - cx) / (bw / 2.0)) ** 2 <= 1.0] = 1.0
    return alpha


def _feather(alpha: np.ndarray, width: int = 2) -> np.ndarray:
    """Soften a binary occupancy mask with a small separable box blur so
    layer edges get fractional coverage."""
    size = alpha.shape[0]
    a = alpha
    for axis in (0, 1):
        pad = np.concatenate([np.take(a, [0] * width, axis), a,
                              np.take(a, [-1] * width, axis)], axis)
        cs = np.cumsum(pad, axis=axis, dtype=np.float32)
        first = np.take(pad, range(0, size), axis)
        a = (np.take(cs, range(2 * width, 2 * width + size), axis)
             - np.take(cs, range(size), axis) + first) / (2 * width + 1)
    return np.clip(a, 0.0, 1.0)


def make_scene(rng: np.random.Generator, size: int = 128,
               disp_bg: float = -1.0, disp_fg: float = 1.0,
               nviews=(9, 9), extra_disps=()):
    """Render one scene; returns (views[r][c], gt, mpi, fg_alpha).

    The MPI alpha channel stores each plane's visible compositing weight
    (front-to-back over-compositing), so per-pixel alpha sums are 1.
    """
    w, h = nviews
    # the full-coverage background is the farthest layer; extras behind it
    # would be invisible and are dropped
    partial = sorted(float(x) for x in (disp_fg,) + tuple(extra_disps)
                     if float(x) > float(disp_bg))
    disps = [float(disp_bg)] + partial
    textures = [_texture(rng, size) for _ in disps]
    alphas = [np.ones((size, size), np.float32)] + \
        [_feather(_layer_alpha(rng, size)) for _ in disps[1:]]

    # front-to-back visibility: comp_k = a_k · Π_{j nearer} (1 − a_j)
    comps = [np.zeros_like(a) for a in alphas]
    trans = np.ones((size, size), np.float32)
    for k in range(len(disps) - 1, -1, -1):          # nearest → farthest
        comps[k] = alphas[k] * trans
        trans = trans * (1.0 - alphas[k])

    # GT disparity: the dominant (max-weight) plane per pixel
    comp_stack = np.stack(comps)                      # (K, H, W)
    gt = np.asarray(disps, np.float32)[comp_stack.argmax(0)]

    mpi = np.zeros((len(disps), size, size, 5), dtype=np.float32)
    for k, (d, t, c) in enumerate(zip(disps, textures, comps)):
        mpi[k, ..., :3] = t
        mpi[k, ..., 3] = c
        mpi[k, ..., 4] = d

    views = {}
    cy, cx = h // 2, w // 2
    for r in range(h):
        for c in range(w):
            # view at grid offset (dr, dc) sees content shifted so that an
            # EPI-Shift by `disp` re-centres disparity `disp` to zero
            dr, dc = r - cy, c - cx
            img = _shift_img(textures[0], -disps[0] * dr, -disps[0] * dc)
            for d, t, a in zip(disps[1:], textures[1:], alphas[1:]):
                t_v = _shift_img(t, -d * dr, -d * dc)
                a_v = _shift_img(a[..., None], -d * dr, -d * dc)[..., 0]
                img = a_v[..., None] * t_v + (1.0 - a_v[..., None]) * img
            views[(r, c)] = img
    return views, gt, mpi, alphas[1]


def write_scene(scene_dir: str, views, gt, mpi, nviews=(9, 9)):
    """Write a scene in the on-disk format the HCI4D loader expects."""
    os.makedirs(scene_dir, exist_ok=True)
    w, h = nviews
    for r in range(h):
        for c in range(w):
            idx = r * w + c
            save_img(os.path.join(scene_dir, f'input_Cam{idx:03d}.png'),
                     np.clip(views[(r, c)], 0.0, 1.0))
    # PFM is stored bottom-up; loaders flip on read
    pfm.save(os.path.join(scene_dir, 'gt_disp_lowres.pfm'),
             np.flip(gt.astype(np.float32), 0).copy())
    # npz layout: (H, W, K, 5) bottom-up (see data/hci4d.py load path)
    mpi_file = np.flip(np.transpose(mpi, (1, 2, 0, 3)), 0)
    np.savez_compressed(os.path.join(scene_dir, 'gt_mpi_lowres.npz'),
                        mpi=mpi_file.astype(np.float32))


def generate_dataset(root: str, scenes: int = 4, size: int = 128,
                     seed: int = 0, disp_range: float = 1.8,
                     disp_center: float = 0.0, layers: int = 2):
    """Generate ``scenes`` scene directories under ``root``.

    ``disp_center`` offsets every layer disparity (an off-center dataset,
    validated with ``--train_shift``); ``layers`` >= 2 adds extra occluders
    at random disparities in the same range.
    """
    rng = np.random.default_rng(seed)
    os.makedirs(root, exist_ok=True)
    for s in range(scenes):
        disp_bg = float(rng.uniform(-disp_range, 0.0)) + disp_center
        disp_fg = float(rng.uniform(0.0, disp_range)) + disp_center
        # extras live strictly in front of the background; the low bound is
        # clamped so a tiny disp_range cannot reverse the interval
        extra_lo = min(disp_bg - disp_center + 0.05, disp_range)
        extra = [float(rng.uniform(extra_lo, disp_range)) + disp_center
                 for _ in range(max(0, layers - 2))]
        views, gt, mpi, _ = make_scene(rng, size, disp_bg, disp_fg,
                                       extra_disps=extra)
        write_scene(os.path.join(root, f'scene_{s:02d}'), views, gt, mpi)
    return root


def main():
    import click

    @click.command()
    @click.argument('output_dir', type=click.Path())
    @click.option('--scenes', default=4, help='Number of scenes')
    @click.option('--size', default=128, help='Scene edge length in pixels')
    @click.option('--seed', default=0, help='RNG seed')
    @click.option('--disp_range', default=1.8,
                  help='Max |disparity| of the two planes')
    @click.option('--disp_center', default=0.0,
                  help='Disparity offset (2.5 = reference-style off-center)')
    @click.option('--layers', default=2, help='Number of depth layers')
    def cli(output_dir, scenes, size, seed, disp_range, disp_center,
            layers):
        generate_dataset(output_dir, scenes, size, seed, disp_range,
                         disp_center, layers)
        print(f'Wrote {scenes} synthetic scenes to {output_dir}')

    cli()


if __name__ == '__main__':
    main()
