"""Deep-learning utility surface, mirroring the reference module layout.

The reference groups ModelSaver / save_img / codecs / BatchIter in
``mmlf/utils/dl.py``; users migrating from it find the same names here.
The implementations live in their natural homes
(train/checkpoint.py, utils/imgio.py, ops/codecs.py).
"""

from __future__ import annotations

import numpy as np
import torch

from ..ops.codecs import class_to_reg, mpi_to_weights, reg_to_class  # noqa: F401
from ..train.checkpoint import ModelSaver  # noqa: F401
from .imgio import save_img  # noqa: F401


class BatchIter:
    """Run a callable once per batch item and re-stack the outputs
    (reference mmlf/utils/dl.py:185-231 — unused there, provided for
    completeness).  The outputs are tensors or numpy arrays; each is
    concatenated along axis 0 as its kind is."""

    def __init__(self, net):
        self.net = net

    def __call__(self, *args):
        b = args[0].shape[0]
        results = [self.net(*(a[i:i + 1] for a in args))
                   for i in range(b)]
        return [torch.cat(parts) if torch.is_tensor(parts[0])
                else np.concatenate(parts, 0)
                for parts in ([r[j] for r in results]
                              for j in range(len(results[0])))]
