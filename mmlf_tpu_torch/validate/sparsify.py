"""Sparsification analysis: oracle-vs-uncertainty curves + AUC.

``python -m mmlf_tpu_torch.validate.sparsify OUTPUT_DIR [--step --mse/--badpix
--random]`` over the artifacts written by the validate CLI
(reference: mmlf/validate/sparsify.py).

Instead of recomputing a masked loss from scratch for every fraction
(the reference's O(N²) loop), pixels are argsorted once by error / by
uncertainty and the curves come from cumulative sums — identical values,
O(N log N).  The reference's (commented-out) per-step debug images are not
reproduced.
"""

from __future__ import annotations

import os
import sys

import click
import numpy as np

from ..utils import pfm


def masked_mse(pred, target, mask):
    return float(np.sum(((pred - target) ** 2.0) * mask) / np.sum(mask))


def masked_l1(pred, target, mask):
    return float(np.sum(np.abs(pred - target) * mask) / np.sum(mask))


def masked_badpix(pred, target, mask, threshold: float = 0.07):
    bad = (np.abs(pred - target) > threshold).astype(np.float64)
    return float(np.sum(bad * mask) / np.sum(mask))


def auc(curve, step: float) -> float:
    """Trapezoidal area under a sampled curve."""
    curve = np.asarray(curve, dtype=np.float64)
    return float(np.sum((curve[:-1] + curve[1:]) / 2.0 * step))


def _cum_curve(values_per_pixel, order, ks):
    """Mean of the k smallest (by ``order``) per fraction, via prefix sums."""
    sorted_vals = values_per_pixel[order]
    csum = np.concatenate([[0.0], np.cumsum(sorted_vals, dtype=np.float64)])
    out = np.zeros(len(ks))
    for i, k in enumerate(ks):
        out[i] = csum[k] / k if k > 0 else 0.0
    return out


def sparsification_curves(gt, result, uncert, step: float = 0.01,
                          use_mse: bool = True):
    """Returns (fractions_remaining, oracle_curve, uncert_curve) — raw,
    before the reference's reverse + normalize."""
    if use_mse:
        per_px = (result - gt) ** 2.0
    else:
        per_px = (np.abs(result - gt) > 0.07).astype(np.float64)
    error = np.abs(result - gt)

    n = gt.size
    fracts = np.arange(0.0, 1.000000001, step)
    ks = [0 if i == 0 else (n if f >= 1.0 else int(f * n))
          for i, f in enumerate(fracts)]

    oracle = _cum_curve(per_px, np.argsort(error, kind='stable'), ks)
    unc = _cum_curve(per_px, np.argsort(uncert, kind='stable'), ks)
    return 1.0 - fracts, oracle, unc


@click.command()
@click.argument('output_dir', type=click.Path(exists=True))
@click.option('--step', default=0.01, help='Step size for sparsification.')
@click.option('--mse/--badpix', default=True, help='Use MSE or BadPix?')
@click.option('--random', is_flag=True, default=False,
              help='Use Random Baseline?')
def main(output_dir, step, mse, random):
    scenes = sorted(f.path for f in os.scandir(
        os.path.join(output_dir, 'scenes')) if f.is_dir())

    n_pts = int(1.0 / step) + 1
    loss = np.zeros((3, n_pts))
    for scene in scenes:
        gt = pfm.load(os.path.join(scene, 'gt.pfm')).flatten()
        result = pfm.load(os.path.join(scene, 'result.pfm')).flatten()
        uncert = pfm.load(os.path.join(scene, 'uncert.pfm')).flatten()
        if random:
            print('Use Random')
            uncert = np.random.random(uncert.size)

        fr, oracle, unc = sparsification_curves(gt, result, uncert, step,
                                                mse)
        loss[0] = fr
        loss[1] += oracle
        loss[2] += unc

    loss = loss[:, ::-1]
    loss[1:3] /= loss[1, 0]
    loss = np.delete(loss, -1, axis=1)
    sparse_error = loss[2] - loss[1]

    with open(os.path.join(output_dir, 'sparsify.csv'), 'w') as f:
        header = 'frac,     oracle,     uncert, sparse_err'
        print(header)
        print(header, file=f)
        for i in range(loss.shape[1]):
            line = (f'{loss[0, i]:.2f}, {loss[1, i]:.8f}, '
                    f'{loss[2, i]:.8f}, {sparse_error[i]:.8f}')
            print(line)
            print(line, file=f)

    print('----------------------------------------')
    print('AUC: ', auc(sparse_error, step))


if __name__ == '__main__':
    sys.exit(main())
