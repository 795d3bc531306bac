"""Dump one pixel's posterior to CSV + mark the pixel on the center view.

``python -m mmlf_tpu_torch.utils.post2csv OUTPUT_DIR X Y [--start --stop]``
(reference: mmlf/utils/post2csv.py): the posterior is AUC-normalized over
the disparity support.
"""

from __future__ import annotations

import os
import sys

import click
import numpy as np

from .imgio import load_img, save_img


def curve_auc(ys, step):
    ys = np.asarray(ys, np.float64)
    return float(np.sum((ys[:-1] + ys[1:]) / 2.0 * step))


@click.command()
@click.argument('output_dir', type=click.Path(exists=True))
@click.argument('x', type=int)
@click.argument('y', type=int)
@click.option('--start', default=-3.5, help='lower limit')
@click.option('--stop', default=3.5, help='upper limit')
def main(output_dir, x, y, start, stop):
    posterior = np.load(os.path.join(output_dir, 'posterior.npy'))
    if posterior.ndim == 4:
        posterior = posterior[0]

    n = posterior.shape[0]
    p = posterior[:, y, x].astype(np.float64)
    p = p / curve_auc(p, (stop - start) / float(n))

    with open(os.path.join(output_dir, f'posterior_{x}_{y}.csv'), 'w') as f:
        f.write('y, p\n')
        for i in range(n):
            disp = float(i) / float(n - 1) * (stop - start) + start
            f.write(f'{disp}, {p[i]}\n')

    center = load_img(os.path.join(output_dir, 'center.png'))
    center[y, x] = np.asarray([1.0, 0.0, 0.0], np.float32)[:center.shape[-1]]
    save_img(os.path.join(output_dir, f'center_{x}_{y}.png'), center)


if __name__ == '__main__':
    sys.exit(main())
