"""Ground-truth mode clustering: per-pixel k-mode extraction at depth edges.

``python -m mmlf_tpu_torch.validate.cluster OUTPUT_DIR [--radius -k]``
(reference: mmlf/validate/cluster.py): pixels on Sobel edges (magnitude
> 0.5) get k=2 disparity modes from a radius-r disc neighborhood via
k-means; everywhere else both modes equal the GT.  Writes
``gt_modes.npy`` per scene.

The environment has no sklearn, and the reference runs one KMeans per edge
pixel in Python; here a vectorized Lloyd's iteration runs over *all* edge
pixels at once (neighborhoods gathered as one array), which is both
dependency-free and orders of magnitude faster.
"""

from __future__ import annotations

import math
import os
import sys

import click
import numpy as np
from scipy.ndimage import sobel

from ..utils import pfm
from ..utils.imgio import save_img


def disc_offsets(radius: float):
    r = math.ceil(radius)
    offs = [(dy, dx) for dy in range(-r, r + 1) for dx in range(-r, r + 1)
            if (dy * dy + dx * dx) ** 0.5 <= radius]
    return np.asarray(offs, dtype=np.int64)


def gather_neighborhoods(gt: np.ndarray, ys, xs, offs):
    """(P, M) disparity neighborhoods with clamped borders."""
    h, w = gt.shape
    sy = np.clip(ys[:, None] + offs[None, :, 0], 0, h - 1)
    sx = np.clip(xs[:, None] + offs[None, :, 1], 0, w - 1)
    return gt[sy, sx]


def kmeans_1d(samples: np.ndarray, k: int = 2, iters: int = 25):
    """Vectorized Lloyd's algorithm on (P, M) scalar sample sets.

    Returns (P, k) sorted cluster centers.  Centers initialize at evenly
    spaced quantiles; empty clusters keep their previous center.
    """
    qs = np.linspace(0.0, 1.0, k)
    centers = np.quantile(samples, qs, axis=1).T          # (P, k)
    for _ in range(iters):
        dist = np.abs(samples[:, :, None] - centers[:, None, :])
        assign = np.argmin(dist, axis=2)                   # (P, M)
        new_centers = centers.copy()
        for j in range(k):
            sel = assign == j
            cnt = sel.sum(1)
            sums = np.where(sel, samples, 0.0).sum(1)
            nz = cnt > 0
            new_centers[nz, j] = sums[nz] / cnt[nz]
        if np.allclose(new_centers, centers, atol=1e-7):
            centers = new_centers
            break
        centers = new_centers
    return np.sort(centers, axis=1)


def cluster_modes(gt: np.ndarray, radius: float = 2.0, k: int = 2,
                  edge_threshold: float = 0.5):
    """Per-pixel k disparity modes; single mode away from edges."""
    der = np.sqrt(sobel(gt, 0) ** 2.0 + sobel(gt, 1) ** 2.0)
    edges = der > edge_threshold

    modes = np.repeat(gt[:, :, None], k, axis=2).astype(np.float64)
    ys, xs = np.nonzero(edges)
    if len(ys):
        hoods = gather_neighborhoods(gt, ys, xs, disc_offsets(radius))
        modes[ys, xs] = kmeans_1d(hoods, k)
    return modes


@click.command()
@click.argument('output_dir', type=click.Path(exists=True))
@click.option('--radius', default=2.0, help='Radius of neighborhood')
@click.option('-k', default=2, help='Number of modes')
def main(output_dir, radius, k):
    scenes = sorted(f.path for f in os.scandir(
        os.path.join(output_dir, 'scenes')) if f.is_dir())

    for scene in scenes:
        gt = np.flip(pfm.load(os.path.join(scene, 'gt.pfm')), 0)
        modes = cluster_modes(gt, radius, k)
        np.save(os.path.join(scene, 'gt_modes.npy'), modes)
        for i in range(k):
            save_img(os.path.join(scene, f'mode_{i}.png'), modes[:, :, i])
        print(f'{scene}: {int((modes[..., 0] != modes[..., -1]).sum())} '
              'multimodal pixels')


if __name__ == '__main__':
    sys.exit(main())
