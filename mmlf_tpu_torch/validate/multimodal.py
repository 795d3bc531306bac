"""Multimodal metrics: mode-MSE / mode-BadPix at GT-multimodal pixels.

``python -m mmlf_tpu_torch.validate.multimodal OUTPUT_DIR [--start --stop
--multi/--uni --lb]`` (reference: mmlf/validate/multimodal.py): at pixels
whose two GT modes differ (from ``gt_modes.npy``), take the top-k local
maxima of the saved 108-bin posterior as predicted modes and score them
against the GT modes (or, with ``--lb``, the best single mode against the
GT disparity; with ``--uni``, the plain prediction).

Vectorized over pixels instead of the reference's four nested Python loops.
"""

from __future__ import annotations

import os
import sys

import click
import numpy as np

from ..utils.imgio import save_img
from ..utils.pfm import load

BAD_PIX_T = 0.07
LOSS_MARGIN = 15


def posterior_local_maxima(posterior: np.ndarray) -> np.ndarray:
    """Zero everywhere except strict interior local maxima along axis 0."""
    out = np.zeros_like(posterior)
    interior = (posterior[1:-1] > posterior[:-2]) & \
        (posterior[1:-1] > posterior[2:])
    out[1:-1] = np.where(interior, posterior[1:-1], 0.0)
    return out


def topk_mode_disparities(post_modes: np.ndarray, k: int,
                          start: float, stop: float) -> np.ndarray:
    """(k, H, W) disparities of the k highest local maxima, sorted."""
    s = post_modes.shape[0]
    flat = post_modes.reshape(s, -1)
    best = np.argpartition(flat, -k, axis=0)[-k:]           # (k, P)
    disps = best.astype(np.float64) / float(s - 1) * (stop - start) + start
    disps = np.sort(disps, axis=0)
    return disps.reshape((k,) + post_modes.shape[1:])


@click.command()
@click.argument('output_dir', type=click.Path(exists=True))
@click.option('--start', default=-3.5, help='lower limit')
@click.option('--stop', default=3.5, help='upper limit')
@click.option('--multi/--uni', is_flag=True, default=True,
              help='score posterior modes (multi) or the point estimate')
@click.option('--lb', is_flag=True, default=False,
              help='lower bound: best mode vs GT disparity')
def main(output_dir, start, stop, multi, lb):
    scenes = sorted(f.path for f in os.scandir(
        os.path.join(output_dir, 'scenes')) if f.is_dir())

    sum_mse = sum_badpix = 0.0
    cnt = 0

    for s_i, scene in enumerate(scenes):
        modes = np.load(os.path.join(scene, 'gt_modes.npy'))
        pred = np.flip(load(os.path.join(scene, 'result.pfm')), 0)
        gt = np.flip(load(os.path.join(scene, 'gt.pfm')), 0)
        h, w, k = modes.shape

        mm = modes[..., 0] != modes[..., 1]
        margin = np.zeros((h, w), bool)
        margin[LOSS_MARGIN:h - LOSS_MARGIN,
               LOSS_MARGIN:w - LOSS_MARGIN] = True
        sel = mm & margin

        mse = np.zeros((h, w))
        badpix = np.zeros((h, w))

        if multi:
            posterior = np.load(os.path.join(scene, 'posterior.npy'))
            if posterior.ndim == 4:
                posterior = posterior[0]
            disps = topk_mode_disparities(
                posterior_local_maxima(posterior), k, start, stop)
            if lb:
                err = (gt[None] - disps) ** 2.0
                mse = np.where(sel, err.min(0), 0.0)
                badpix = np.where(
                    sel, (np.abs(gt[None] - disps) > BAD_PIX_T).min(0), 0.0)
            else:
                err = (np.moveaxis(disps, 0, -1) - modes) ** 2.0
                mse = np.where(sel, err.mean(-1), 0.0)
                badpix = np.where(
                    sel,
                    (np.abs(np.moveaxis(disps, 0, -1) - modes)
                     > BAD_PIX_T).mean(-1), 0.0)
        else:
            mse = np.where(sel, (gt - pred) ** 2.0, 0.0)
            badpix = np.where(sel,
                              (np.abs(gt - pred) > BAD_PIX_T).astype(float),
                              0.0)

        cnt += int(sel.sum())
        save_img(f'mse_{s_i}.png', mse)
        save_img(f'badpix_{s_i}.png', badpix)
        print(np.mean(mse), np.mean(badpix))

        sum_mse += float(mse.sum())
        sum_badpix += float(badpix.sum())

    sum_mse /= float(cnt)
    sum_badpix /= float(cnt)
    print('MSE:', sum_mse)
    print('BadPix:', sum_badpix)


if __name__ == '__main__':
    sys.exit(main())
