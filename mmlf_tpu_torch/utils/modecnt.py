"""Posterior mode counting: multimodality maps from saved posteriors.

``python -m mmlf_tpu_torch.utils.modecnt OUTPUT_DIR [--outlier]``
(reference: mmlf/utils/modecnt.py): Gaussian-smooth each pixel's posterior
along the bin axis (σ=2), find local maxima/minima, reject outliers
(maxima below ``outlier``·strongest, minima above weakest/``outlier``), and
write ``mode_cnt.png`` (more than one clean maximum) plus
``mode_prop.{png,pfm}`` (strength ratio of the 2nd mode to the valley
between the top-2 modes).

Vectorized over all pixels (the reference loops per pixel in Python).
"""

from __future__ import annotations

import os
import sys

import click
import numpy as np
from scipy.ndimage import gaussian_filter1d

from . import pfm
from .imgio import save_img


def mode_analysis(posterior: np.ndarray, outlier: float = 0.1):
    """Returns (mode_cnt, mode_prop) maps for a (S, H, W) posterior."""
    s, h, w = posterior.shape
    p = posterior.reshape(s, -1)                       # (S, P)

    interior_max = np.zeros_like(p, dtype=bool)
    interior_min = np.zeros_like(p, dtype=bool)
    interior_max[1:-1] = (p[1:-1] > p[:-2]) & (p[1:-1] > p[2:])
    interior_min[1:-1] = (p[1:-1] < p[:-2]) & (p[1:-1] < p[2:])

    max_vals = np.where(interior_max, p, -np.inf)
    min_vals = np.where(interior_min, p, np.inf)

    strongest = max_vals.max(0)                        # (P,)
    weakest = min_vals.min(0)

    clean_max = interior_max & (max_vals > strongest * outlier)
    clean_max_vals = np.where(clean_max, p, -np.inf)
    n_clean = clean_max.sum(0)
    mode_cnt = (n_clean > 1)

    # top-2 clean maxima by value
    top2 = np.argpartition(clean_max_vals, -2, axis=0)[-2:]   # (2, P)
    v1 = np.take_along_axis(clean_max_vals, top2[1:2], 0)[0]  # strongest
    v2 = np.take_along_axis(clean_max_vals, top2[0:1], 0)[0]  # runner-up
    i_lo = np.minimum(top2[0], top2[1])
    i_hi = np.maximum(top2[0], top2[1])

    # smallest *minimum* strictly between the two modes (all minima, like
    # the reference, not just outlier-cleaned ones)
    bins = np.arange(s)[:, None]
    between = (bins > i_lo[None]) & (bins < i_hi[None])
    valley = np.where(between & interior_min, p, np.inf).min(0)

    mode_prop = np.zeros(p.shape[1])
    ok = mode_cnt & np.isfinite(valley) & np.isfinite(v2)
    mode_prop[ok] = v2[ok] / valley[ok]

    return (mode_cnt.reshape(h, w).astype(np.float64),
            mode_prop.reshape(h, w))


@click.command()
@click.argument('output_dir', type=click.Path(exists=True))
@click.option('--outlier', default=0.1,
              help='proportional outlier threshold')
def main(output_dir, outlier):
    scenes = sorted(f.path for f in os.scandir(
        os.path.join(output_dir, 'scenes')) if f.is_dir())

    for scene in scenes:
        print(f'Processing scene {scene}...')
        posterior = np.load(os.path.join(scene, 'posterior.npy'))
        if posterior.ndim == 4:
            posterior = posterior[0]
        posterior = gaussian_filter1d(posterior, sigma=2, axis=0)

        mode_cnt, mode_prop = mode_analysis(posterior, outlier)

        save_img(os.path.join(scene, 'mode_cnt.png'), mode_cnt)
        save_img(os.path.join(scene, 'mode_prop.png'),
                 np.clip(mode_prop, 0, 10))
        pfm.save(os.path.join(scene, 'mode_prop.pfm'),
                 np.flip(mode_prop.astype(np.float32), 0).copy())


if __name__ == '__main__':
    sys.exit(main())
