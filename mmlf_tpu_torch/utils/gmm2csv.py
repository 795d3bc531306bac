"""Dump one pixel's Gaussian mixture to CSV for pgfplots.

``python -m mmlf_tpu_torch.utils.gmm2csv INPUT OUTPUT X Y [--start --stop
--step --sum_only]`` (reference: mmlf/utils/gmm2csv.py): either the
max-normalized mixture sum or one column per component.
"""

from __future__ import annotations

import sys

import click
import numpy as np


def gaussian(x, mean, var):
    return 1.0 / np.sqrt(2.0 * np.pi * var) * \
        np.exp(-(x - mean) ** 2.0 / (2.0 * var))


def mixture_curve(means, variances, start, stop, step):
    xs = np.arange(start, stop, step)
    ys = sum(gaussian(xs, m, v) / v for m, v in zip(means, variances))
    return xs, ys


@click.command()
@click.argument('input', type=click.Path(exists=True))
@click.argument('output', type=click.Path())
@click.argument('x', type=int)
@click.argument('y', type=int)
@click.option('--start', default=-3.5, help='lower limit')
@click.option('--stop', default=3.5, help='upper limit')
@click.option('--step', default=0.005, help='step width')
@click.option('--sum_only', is_flag=True, help='sum over gaussians?')
def main(input, output, x, y, start, stop, step, sum_only):
    gmm = np.load(input)
    means = gmm[0, :, y, x]
    variances = gmm[1, :, y, x]

    if sum_only:
        xs, ys = mixture_curve(means, variances, start, stop, step)
        ys = ys / max(ys.max(), 1e-12)
        with open(output, 'w') as f:
            f.write('x, p\n')
            for xi, yi in zip(xs, ys):
                f.write(f'{xi}, {yi}\n')
    else:
        xs = np.arange(start, stop, step)
        cols = [gaussian(xs, m, v) / v
                for m, v in zip(means, variances)]
        with open(output, 'w') as f:
            f.write('x, ' + ', '.join(
                f'G_{i}' for i in range(len(cols))) + '\n')
            for j, xi in enumerate(xs):
                f.write(f'{xi}, ' + ', '.join(
                    str(c[j]) for c in cols) + '\n')


if __name__ == '__main__':
    sys.exit(main())
