"""Mask builders: margin masks and the texture mask."""

from __future__ import annotations

import numpy as np
import torch

from ..native import texture_mask as native_texture_mask


def create_mask_margin(shape, margin: int = 0, device=None) -> torch.Tensor:
    """Boolean mask with a ``margin``-wide False border on the last two
    dims."""
    if margin < 0:
        raise ValueError(f'margin must be >= 0, got {margin}')
    mask = torch.ones(tuple(shape), dtype=torch.bool, device=device)
    if margin > 0:
        h, w = shape[-2], shape[-1]
        rows = torch.arange(h, device=device)
        cols = torch.arange(w, device=device)
        row_ok = (rows >= margin) & (rows < h - margin)
        col_ok = (cols >= margin) & (cols < w - margin)
        mask = mask & row_ok[:, None] & col_ok[None, :]
    return mask


def create_mask_margin_np(shape, margin: int = 0) -> np.ndarray:
    """Numpy variant for host-side dataset code."""
    if margin < 0:
        raise ValueError(f'margin must be >= 0, got {margin}')
    mask = np.ones(shape, dtype=bool)
    if margin > 0:
        mask[..., :margin, :] = False
        mask[..., -margin:, :] = False
        mask[..., :margin] = False
        mask[..., -margin:] = False
    return mask


def create_mask_texture(center: np.ndarray, wsize: int = 23,
                        threshold: float = 0.02) -> np.ndarray:
    """Texture mask: False where the local mean-absolute-deviation is low.

    For each pixel, the mean L1 distance between the pixel and every pixel
    of its ``wsize``×``wsize`` zero-padded neighbourhood (averaged over
    window positions and the 3 colour channels) must be ``>= threshold``;
    a ``wsize // 2`` margin is additionally masked out.  Runs as an
    accumulation over window offsets on the host: in the port's native
    library (``native.texture_mask``, multithreaded) when it is available,
    as the JAX package does by default, else in numpy.  The two round the
    last step differently (``acc * (1/n)`` against ``acc / n``), as the JAX
    package's two paths do, and each equals its JAX twin bit for bit.

    :param center: ``(H, W, 3)`` float32 centre view (channel-last)
    :returns: ``(H, W)`` int32 mask
    """
    center = np.asarray(center, dtype=np.float32)
    out = native_texture_mask(center, wsize, threshold)
    if out is not None:
        return out

    h, w, c = center.shape
    r = wsize // 2

    padded = np.pad(center, ((r, r), (r, r), (0, 0)))
    acc = np.zeros((h, w), dtype=np.float32)
    for dy in range(wsize):
        for dx in range(wsize):
            acc += np.abs(padded[dy:dy + h, dx:dx + w] - center).sum(-1)
    mad = acc / float(wsize * wsize * c)

    mask = (mad >= threshold).astype(np.int32)
    mask *= create_mask_margin_np((h, w), r).astype(np.int32)
    return mask
