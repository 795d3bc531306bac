"""Reference two-Gaussian example curve to CSV (figure demo).

``python -m mmlf_tpu_torch.utils.gmm2csv2 OUTPUT [--start --stop --step]``
(reference: mmlf/utils/gmm2csv2.py): a fixed 2-component mixture
(μ = ±1, σ² = 0.3/0.4), max-normalized.
"""

from __future__ import annotations

import sys

import click

from .gmm2csv import mixture_curve


@click.command()
@click.argument('output', type=click.Path())
@click.option('--start', default=-3.5, help='lower limit')
@click.option('--stop', default=3.5, help='upper limit')
@click.option('--step', default=0.005, help='step width')
def main(output, start, stop, step):
    xs, ys = mixture_curve([-1.0, 1.0], [0.3, 0.4], start, stop, step)
    ys = ys / max(ys.max(), 1e-12)
    with open(output, 'w') as f:
        f.write('x, p\n')
        for xi, yi in zip(xs, ys):
            f.write(f'{xi}, {yi}\n')


if __name__ == '__main__':
    sys.exit(main())
