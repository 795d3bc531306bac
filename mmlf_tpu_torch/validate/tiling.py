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
stacks.  The ported heads (BASE, UPR, DPP, ESE) have no constant-size
output, so one probe at the window size finds the pair; the JAX package's
second probe at another window size is needed only once the INN is ported
(ROADMAP.md Queue 1 item 7), whose ``mu`` can coincide with the window.
Nothing is stitched on a canvas, so nothing is cropped (the JAX package's
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


def spatial_dims(shape, win_sz: int):
    """Index of the first adjacent ``(win_sz, win_sz)`` pair of ``shape``,
    or None for an output with no spatial extent."""
    for i in range(len(shape) - 1):
        if shape[i] == win_sz and shape[i + 1] == win_sz:
            return i
    return None


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
def tiled_forward(apply_fn, stacks, tile: int, halo: int) -> dict:
    """Run ``apply_fn`` over overlapping tiles and stitch the interiors.

    :param apply_fn: ``fn(h, v, i, d) -> output dict`` on one window;
        outputs with a spatial ``(win, win)`` pair are stitched, the others
        come back as None
    :param stacks: four ``(b, n, H, W, 3)`` view stacks on one device
    :param tile: interior tile size (output pixels per tile per axis)
    :param halo: overlap on each side; at least the receptive radius
    :returns: output dict at full scene size, on the stacks' device
    """
    h, w = stacks[0].shape[2:4]
    win_sz = tile + 2 * halo
    outputs = sdim = None
    for y0, x0, wy0, wx0, iy, ix in tile_positions(h, w, tile, halo).tolist():
        out = apply_fn(*[s[:, :, wy0:wy0 + win_sz, wx0:wx0 + win_sz]
                         for s in stacks])
        if outputs is None:
            sdim = {k: None if v is None else spatial_dims(v.shape, win_sz)
                    for k, v in out.items()}
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
