"""Edge maps: Sobel-magnitude threshold PNG per dataset scene.

``python -m mmlf_tpu_torch.validate.edges DATASET``
(reference: mmlf/validate/edges.py).
"""

from __future__ import annotations

import os
import sys

import click
import numpy as np
from scipy.ndimage import sobel

from ..utils import pfm
from ..utils.imgio import save_img


def edge_mask(disp: np.ndarray, threshold: float = 0.5) -> np.ndarray:
    """Binary float32 mask of disparity discontinuities.

    Sobel gradient magnitude over both axes, thresholded — the GT edge
    definition the multimodal analysis chain keys off.
    """
    magnitude = np.hypot(sobel(disp, 0), sobel(disp, 1))
    return (magnitude > threshold).astype(np.float32)


@click.command()
@click.argument('dataset', type=click.Path(exists=True))
def main(dataset):
    scenes = sorted(f.path for f in os.scandir(dataset) if f.is_dir())
    for scene in scenes:
        gt_path = os.path.join(scene, 'gt_disp_lowres.pfm')
        gt = np.flip(pfm.load(gt_path), 0)
        save_img(os.path.join(scene, 'edges.png'), edge_mask(gt))


if __name__ == '__main__':
    sys.exit(main())
