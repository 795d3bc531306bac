"""Dump one pixel's Gaussian (mean + logvar PFMs) to CSV, max-normalized.

``python -m mmlf_tpu_torch.utils.uncert2csv MEAN VARIANCE OUTPUT X Y
[--start --stop --step]`` (reference: mmlf/utils/uncert2csv.py).
"""

from __future__ import annotations

import sys

import click
import numpy as np

from . import pfm
from .gmm2csv import gaussian


@click.command()
@click.argument('mean', type=click.Path(exists=True))
@click.argument('variance', type=click.Path(exists=True))
@click.argument('output', type=click.Path())
@click.argument('x', type=int)
@click.argument('y', type=int)
@click.option('--start', default=-3.5, help='lower limit')
@click.option('--stop', default=3.5, help='upper limit')
@click.option('--step', default=0.005, help='step width')
def main(mean, variance, output, x, y, start, stop, step):
    mu = np.flip(pfm.load(mean), 0)[y][x]
    var = np.exp(np.flip(pfm.load(variance), 0)[y][x])

    xs = np.arange(start, stop, step)
    ys = gaussian(xs, mu, var)
    ys = ys / max(ys.max(), 1e-12)

    with open(output, 'w') as f:
        f.write('x, p\n')
        for xi, yi in zip(xs, ys):
            f.write(f'{xi}, {yi}\n')


if __name__ == '__main__':
    sys.exit(main())
