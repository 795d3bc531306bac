"""Overlapping-tile inference for full scenes (``--val_tile``).

The port of ``mmlf_tpu/validate/tiling.py``.  The net is fully
convolutional, so a scene can run as overlapping windows of ``tile + 2 *
halo`` pixels a side: with a halo of at least the net's receptive radius,
each window's interior equals the whole-scene forward there (zero padding
only ever meets the true image border), and only the interiors are kept.
Peak device memory then follows the window, not the scene.

The tiles run as a Python loop over ``tile_positions``: each takes a view
of the four device stacks (no copy), runs the per-tile apply and writes
its interior into full-size device buffers allocated from the first
tile's outputs.  The JAX package scans the tiles in one compiled program
over a canvas padded to a tile multiple, then crops; nothing is compiled
per scene here, so the port tiles the true size directly (the positions
are the same: ``tile_positions`` clamps every window inside the true
scene).

Outputs are stitched on their spatial ``(H, W)`` pair, wherever it sits:
``(b, H, W, ...)`` heads and the ensemble's member-major ``(K, b, H, W)``
stacks; outputs with no spatial extent (the INN's per-image ``jac``) come
back as None.  A constant-size output can match the window: the INN's
``mu`` is ``(1, 108, 108)`` and its window under ``--val_tile 64`` is 64 +
2·22 = 108.  ``probe=True`` (the validate CLI sets it for an INN) runs the
JAX package's second probe: one more forward of the first window cut by 8
rows and columns, and a pair counts as spatial only if it tracks the
window at both sizes.  The heads of ``FeedForward`` and the ensemble have
no constant-size output, so their tiled runs skip that forward.  Nothing
is stitched on a canvas, so nothing is cropped (the JAX package's
``crop_outputs`` has no counterpart).
"""

from __future__ import annotations

import numpy as np
import torch


UNET_MSG = ('tiling a U-Net checkpoint is not supported: the U-Net\'s 2x2 '
            'max-pools floor a window whose side is not a multiple of 16 and '
            'its receptive field exceeds the halo (the JAX package fails '
            'here too: its validate CLI raises, its tiled artifact cannot '
            'serve)')


def receptive_radius(ksize: int, in_blocks: int, out_blocks: int) -> int:
    """Upper bound on the one-sided receptive field of the conv trunk.

    Every conv extends the reach by (ksize - 1); each block has two convs.
    """
    return 2 * (in_blocks + out_blocks) * (ksize - 1)


# the U-Net's pooling grid: its four 2x2 max-pools
UNET_ALIGN = 16


def unet_halo(ksize: int, in_blocks: int, depth: int = 5) -> int:
    """A halo that covers the receptive field of a ``--model_unet`` net,
    widened to a multiple of ``UNET_ALIGN``: the stream blocks' reach,
    then per level of scale ``2**l`` two 3×3 convs down (``2·2**l``) and
    a max-pool (``2**l``), and on the way up a 2×2 transposed conv and two
    3×3 convs (``3·2**l``): 128 rows at 3 blocks and depth 5."""
    reach = receptive_radius(ksize, in_blocks, 0) + \
        sum(2 * 2 ** lv for lv in range(depth)) + \
        sum(4 * 2 ** lv for lv in range(depth - 1))
    return -(-reach // UNET_ALIGN) * UNET_ALIGN


def spatial_dims(shape, size, shape2=None, size2=None):
    """Index of the first adjacent pair of ``shape`` equal to ``size`` (an
    ``(h, w)`` pair, or one int for a square window), or None for an
    output with no spatial extent.  Given a second probe's ``shape2`` at
    window ``size2``, the pair must sit at ``size2`` there too."""
    size = (size, size) if isinstance(size, int) else tuple(size)
    for i in range(len(shape) - 1):
        if tuple(shape[i:i + 2]) == size:
            if shape2 is not None and tuple(shape2[i:i + 2]) != tuple(size2):
                continue
            return i
    return None


def probe_spatial(apply_fn, window, out: dict, probe: bool = False) -> dict:
    """``{key: spatial dim or None}`` of ``out = apply_fn(*window)``.  With
    ``probe``, a second forward on the window less 8 rows and columns
    keeps only the pairs that track the window size (a window of 8 or
    less is probed as it is)."""
    size = tuple(window[0].shape[2:4])
    out2 = size2 = None
    if probe and min(size) > 8:
        size2 = (size[0] - 8, size[1] - 8)
        out2 = apply_fn(*[None if s is None else s[:, :, :size2[0], :size2[1]]
                          for s in window])
    return {k: None if v is None else spatial_dims(
        v.shape, size, None if out2 is None or out2[k] is None
        else out2[k].shape, size2) for k, v in out.items()}


def tile_positions(h: int, w: int, tile: int, halo: int) -> np.ndarray:
    """Tile origin table for a scene of ``h × w``.

    Rows are ``(y0, x0, wy0, wx0, iy, ix)``: interior-tile origin (clamped
    to ``size - tile``, so edge tiles overlap their neighbours and rewrite
    identical values), window origin (clamped so the whole halo window
    stays inside the scene), and the interior offset within the window.
    """
    win_sz = tile + 2 * halo
    assert h >= win_sz and w >= win_sz, \
        f'scene {h}x{w} smaller than tile window {win_sz}; lower --val_tile'
    ny = -(-h // tile)
    nx = -(-w // tile)
    pos = []
    for ty in range(ny):
        for tx in range(nx):
            y0 = min(ty * tile, h - tile)
            x0 = min(tx * tile, w - tile)
            wy0 = max(0, min(y0 - halo, h - win_sz))
            wx0 = max(0, min(x0 - halo, w - win_sz))
            pos.append((y0, x0, wy0, wx0, y0 - wy0, x0 - wx0))
    return np.asarray(pos, np.int32)


@torch.no_grad()
def tiled_forward(apply_fn, stacks, tile: int, halo: int,
                  probe: bool = False) -> dict:
    """Run ``apply_fn`` over overlapping tiles and stitch the interiors.

    :param apply_fn: ``fn(h, v, i, d) -> output dict`` on one window;
        outputs with a spatial ``(win, win)`` pair are stitched, the others
        come back as None
    :param stacks: four ``(b, n, H, W, 3)`` view stacks on one device
    :param tile: interior tile size (output pixels per tile per axis)
    :param halo: overlap on each side; at least the receptive radius
    :param probe: find the spatial outputs with a second probe
        (``probe_spatial``), for nets with constant-size outputs
    :returns: output dict at full scene size, on the stacks' device
    """
    h, w = stacks[0].shape[2:4]
    win_sz = tile + 2 * halo
    outputs = sdim = None
    for y0, x0, wy0, wx0, iy, ix in tile_positions(h, w, tile, halo).tolist():
        window = [s[:, :, wy0:wy0 + win_sz, wx0:wx0 + win_sz]
                  for s in stacks]
        out = apply_fn(*window)
        if outputs is None:
            sdim = probe_spatial(apply_fn, window, out, probe)
            outputs = {k: None if d is None else out[k].new_empty(
                out[k].shape[:d] + (h, w) + out[k].shape[d + 2:])
                for k, d in sdim.items()}
        for k, d in sdim.items():
            if d is None:
                continue
            lead = (slice(None),) * d
            outputs[k][lead + (slice(y0, y0 + tile), slice(x0, x0 + tile))] \
                = out[k][lead + (slice(iy, iy + tile), slice(ix, ix + tile))]
    return outputs
