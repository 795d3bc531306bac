"""Dump one pixel's per-class likelihood (from saved NLL scores) to CSV.

``python -m mmlf_tpu_torch.utils.nll2csv INPUT OUTPUT X Y [--start --stop]``
(reference: mmlf/utils/nll2csv.py).
"""

from __future__ import annotations

import sys

import click
import numpy as np


def pixel_likelihood_rows(scores: np.ndarray, x: int, y: int,
                          start: float, stop: float):
    """(disparities, likelihoods) arrays for one pixel.

    ``scores`` is a (bins, h, w) or (1, bins, h, w) NLL volume as written
    by the validate CLI. Bin centers lie on the half-open [start, stop)
    grid — no stop endpoint, matching the reference's bin convention.
    Returned as two arrays, NOT stacked: the likelihood keeps the input's
    float32 dtype so the CSV text reprs match the reference's output
    (stacking would upcast to float64 and change every digit string).
    """
    pixel_nll = (scores[0] if scores.ndim == 4 else scores)[:, y, x]
    n_bins = pixel_nll.shape[0]
    # evaluation order matches the reference's per-bin expression so the
    # float64 disparity labels are bit-identical in the CSV text
    disp = np.arange(n_bins) / n_bins * (stop - start) + start
    return disp, np.exp(-pixel_nll)


@click.command()
@click.argument('input', type=click.Path(exists=True))
@click.argument('output', type=click.Path())
@click.argument('x', type=int)
@click.argument('y', type=int)
@click.option('--start', default=-3.5, help='lower limit')
@click.option('--stop', default=3.5, help='upper limit')
def main(input, output, x, y, start, stop):
    disp, lh = pixel_likelihood_rows(np.load(input), x, y, start, stop)
    with open(output, 'w') as f:
        f.write('disparity, likelihood\n')
        f.writelines(f'{d}, {l}\n' for d, l in zip(disp, lh))


if __name__ == '__main__':
    sys.exit(main())
