"""GMM mode counting + "second chance" analysis of saved per-pixel mixtures.

``python -m mmlf_tpu_torch.utils.gmm_cnt INPUT OUTPUT [--start --stop --step
--device]`` (reference: mmlf/utils/gmm_cnt.py): evaluate each pixel's
Gaussian mixture (``gmm.npy``: ``(2, K, H, W)`` means/vars) on a disparity
grid, count local maxima, and try replacing the point estimate with the
nearest extreme mode where that improves the error ("second chance");
writes ``cnts.png``, ``dist.png``, ``result_min/max/best.png`` and
``second_chance.txt``.

The mode search runs on the device (``--device``, default ``cuda``; it
raises without CUDA), chunked over pixels: the density, the local-maximum
test, the count and the first and last maximum of a chunk stay there, and
only the three ``(H, W)`` maps come back to the host.
"""

from __future__ import annotations

import math
import os
import sys

import click
import numpy as np
import torch

from . import pfm
from .device import resolve_device
from .imgio import save_img
from ..ops.masks import create_mask_margin_np


def mixture_on_grid(means: torch.Tensor, variances: torch.Tensor,
                    grid: torch.Tensor) -> torch.Tensor:
    """(K, P) mixture params + (G,) grid -> (G, P) density
    Σ_k N(x; μ_k, σ²_k)/σ²_k (the extra ``/ σ²`` is the reference's), in
    the inputs' dtype (float32 in ``count_modes``).

    The members are added in order 0..K-1 to zeros, each term rounded as
    ``1/sqrt(2πv) · exp(-(x-μ)²/(2v)) / v``; the in-place steps only spare
    the (G, P) temporaries."""
    acc = torch.zeros((grid.shape[0], means.shape[1]), dtype=means.dtype,
                      device=means.device)
    x = grid[:, None]
    for m, v in zip(means, variances):
        g = (x - m).square_().neg_().div_(2.0 * v).exp_()
        acc.add_(g.mul_(1.0 / torch.sqrt(2.0 * math.pi * v)).div_(v))
    return acc


def local_maxima(dens: torch.Tensor) -> torch.Tensor:
    """(G, P) bool: the strict interior local maxima of each column."""
    is_max = torch.zeros_like(dens, dtype=torch.bool)
    is_max[1:-1] = (dens[1:-1] > dens[:-2]) & (dens[1:-1] > dens[2:])
    return is_max


def mode_maps(is_max: torch.Tensor, start: float, step: float):
    """(counts, first mode, last mode) of each column of a (G, P)
    local-maximum mask: int32 counts, and each mode at ``index * step +
    start`` in float64 (as Python floats) stored in float32, 0 where a
    column has no maximum."""
    g = is_max.shape[0]
    idx = torch.arange(g, dtype=torch.int32, device=is_max.device)[:, None]
    counts = is_max.sum(0, dtype=torch.int32)
    first = torch.where(is_max, idx, g).amin(0)
    last = torch.where(is_max, idx, -1).amax(0)
    has = counts > 0
    return (counts,
            torch.where(has, (first.double() * step + start).float(), 0.0),
            torch.where(has, (last.double() * step + start).float(), 0.0))


def count_modes(gmm: np.ndarray, start: float, stop: float, step: float,
                chunk: int = 8192, device='cuda'):
    """Returns (counts, mode_min, mode_max) maps for a (2, K, H, W) GMM,
    computed on ``device``."""
    dev = resolve_device(device)
    _, k, h, w = gmm.shape
    means = torch.from_numpy(
        gmm[0].reshape(k, -1).astype(np.float32)).to(dev)
    variances = torch.from_numpy(
        gmm[1].reshape(k, -1).astype(np.float32)).to(dev)
    # numpy's grid, whose length and values torch.arange need not repeat
    grid = torch.from_numpy(
        np.arange(start, stop, step, dtype=np.float32)).to(dev)

    counts = torch.zeros(h * w, dtype=torch.int32, device=dev)
    mode_min = torch.zeros(h * w, dtype=torch.float32, device=dev)
    mode_max = torch.zeros(h * w, dtype=torch.float32, device=dev)
    for lo in range(0, h * w, chunk):
        hi = min(lo + chunk, h * w)
        counts[lo:hi], mode_min[lo:hi], mode_max[lo:hi] = mode_maps(
            local_maxima(mixture_on_grid(means[:, lo:hi],
                                         variances[:, lo:hi], grid)),
            start, step)

    return tuple(a.reshape(h, w).cpu().numpy()
                 for a in (counts, mode_min, mode_max))


def second_chance(result, gt, mode_min, mode_max):
    """Replace the prediction with the closer extreme mode where better."""
    res_diff = np.abs(gt - result)
    min_diff = np.abs(gt - mode_min)
    max_diff = np.abs(gt - mode_max)
    better = (res_diff > min_diff) | (res_diff > max_diff)
    take_min = min_diff < max_diff
    out = result.copy()
    out[better & take_min] = mode_min[better & take_min]
    out[better & ~take_min] = mode_max[better & ~take_min]
    return out


@click.command()
@click.argument('input', type=click.Path(exists=True))
@click.argument('output', type=click.Path())
@click.option('--start', default=-3.5, help='lower limit')
@click.option('--stop', default=3.5, help='upper limit')
@click.option('--step', default=0.005, help='step width')
@click.option('--device', default='cuda',
              help='torch device of the mode search (cuda or cpu)')
def main(input, output, start, stop, step, device):
    resolve_device(device)
    gmm = np.load(os.path.join(input, 'gmm.npy'))
    gt = np.flip(pfm.load(os.path.join(input, 'gt.pfm')), 0)
    result = np.flip(pfm.load(os.path.join(input, 'result.pfm')), 0)

    cnts, mode_min, mode_max = count_modes(gmm, start, stop, step,
                                           device=device)
    best = second_chance(result, gt, mode_min, mode_max)

    save_img(os.path.join(input, 'cnts.png'),
             cnts / max(cnts.max(), 1))

    dist_out = np.zeros(cnts.shape + (4,), np.float32)
    dist_out[..., 0] = 1.0
    dists = np.abs(mode_min - mode_max)
    dist_out[..., 3] = dists / max(dists.max(), 1e-9)
    save_img(os.path.join(input, 'dist.png'), dist_out)

    lo = min(mode_min.min(), mode_max.min())
    hi = max(mode_min.max(), mode_max.max())
    rng = max(hi - lo, 1e-9)
    save_img(os.path.join(input, 'result_min.png'), (mode_min - lo) / rng)
    save_img(os.path.join(input, 'result_max.png'), (mode_max - lo) / rng)
    save_img(os.path.join(input, 'result_best.png'), best)

    mask = create_mask_margin_np(best.shape, 15)
    mse = float(np.sum((best - gt) ** 2 * mask) / mask.sum())
    badpix = float(np.sum((np.abs(best - gt) > 0.07) * mask) / mask.sum())
    with open(os.path.join(input, 'second_chance.txt'), 'w') as f:
        print('MSE:', mse, file=f)
        print('BadPix:', badpix, file=f)
    print('MSE:', mse, 'BadPix:', badpix)


if __name__ == '__main__':
    sys.exit(main())
