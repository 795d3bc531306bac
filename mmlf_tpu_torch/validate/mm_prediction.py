"""Multimodality-prediction evaluation: how well ``mode_prop`` detects
GT-multimodal pixels.

``python -m mmlf_tpu_torch.validate.mm_prediction OUTPUT_DIR [--step --random
--save_images]`` (reference: mmlf/validate/mm_prediction.py): a
sparsification-style curve of the detector (pixels ranked by descending
``mode_prop`` from modecnt) against the oracle ranking, with
``loss = 1 − recall``; emits ``mm_pred.csv`` + AUC.

The reference also writes a large visualization PNG per fraction per scene;
that is off by default here (``--save_images`` restores it).
"""

from __future__ import annotations

import os
import sys

import click
import numpy as np

from ..utils import pfm
from ..utils.imgio import load_img, save_img
from .sparsify import auc


def detector_loss(selected_mask, target_mask):
    """1 − recall of multimodal pixels within the selected set."""
    hit = float(np.sum(selected_mask & target_mask))
    return 1.0 - hit / float(np.sum(target_mask))


@click.command()
@click.argument('output_dir', type=click.Path(exists=True))
@click.option('--step', default=0.01, help='Step size for sparsification.')
@click.option('--random', is_flag=True, default=False,
              help='Use Random Baseline?')
@click.option('--save_images', is_flag=True, default=False,
              help='Write the per-fraction visualization PNGs')
def main(output_dir, step, random, save_images):
    scenes = sorted(f.path for f in os.scandir(
        os.path.join(output_dir, 'scenes')) if f.is_dir())

    n_pts = int(1.0 / step) + 1
    loss = np.zeros((3, n_pts))
    fracts = np.arange(0.0, 1.000000001, step)

    for scene in scenes:
        gt_modes = np.load(os.path.join(scene, 'gt_modes.npy'))
        mask_gt = (gt_modes[..., 0] != gt_modes[..., 1]).flatten()
        mode_prop = np.flip(pfm.load(
            os.path.join(scene, 'mode_prop.pfm')), 0).flatten()
        if random:
            print('Use Random')
            mode_prop = np.random.random(mode_prop.size)

        n = mask_gt.size
        # oracle ranks non-multimodal last; detector ranks by mode_prop desc
        order_oracle = np.argsort(~mask_gt, kind='stable')
        order_pred = np.argsort(-mode_prop, kind='stable')

        img = None
        if save_images:
            img = load_img(os.path.join(scene, 'center.png'))

        mask_oracle = np.zeros(n, bool)
        mask_pred = np.zeros(n, bool)
        for i, fract in enumerate(fracts):
            loss[0, i] = 1.0 - fract
            if fract >= 1.0:
                mask_oracle[:] = True
                mask_pred[:] = True
            else:
                k = int(fract * n)
                mask_oracle[order_oracle[:k]] = True
                mask_pred[order_pred[:k]] = True

            loss[1, i] += detector_loss(mask_oracle, mask_gt)
            loss[2, i] += detector_loss(mask_pred, mask_gt)

            if save_images:
                h, w = img.shape[:2]
                red = np.asarray([1.0, 0.0, 0.0], np.float32)
                im_p = img.copy()
                im_p[mask_pred.reshape(h, w)] = red
                im_o = img.copy()
                im_o[mask_oracle.reshape(h, w)] = red
                border = 32
                out = np.zeros((h, 2 * w + border, 3), np.float32)
                out[:, :w] = im_p
                out[:, w + border:] = im_o
                out = np.pad(out, ((104, 104), (112, 112), (0, 0)))
                save_img(os.path.join(scene, f'mm_{i:04d}.png'), out)

    loss[0] = 1.0 - loss[0]
    loss[1:3] /= loss[1, 0]
    loss = np.delete(loss, -1, axis=1)
    sparse_error = loss[2] - loss[1]

    with open(os.path.join(output_dir, 'mm_pred.csv'), 'w') as f:
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
