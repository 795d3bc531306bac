"""BatchNorm of the conv trunk, for eval and train.

The counterpart of ``mmlf_tpu.ops.batchnorm.FusedBatchNorm``.  Its
semantics differ from a stock ``nn.BatchNorm2d`` in training:

  * the running variance is the *biased* batch variance (torch keeps the
    unbiased one), as the JAX package and flax keep it;
  * ``momentum`` is torch's convention, ``ra = (1 - m)·ra + m·batch``
    (flax's momentum is ``1 - m``), and comes from
    ``model_batchnorm_momentum``;
  * eps is 1e-5.

The state-dict keys are those of ``nn.BatchNorm2d`` (``weight``, ``bias``,
``running_mean``, ``running_var``, ``num_batches_tracked``), so reference
``checkpoint.pt`` files load strictly.  Eval mode normalizes with the
running statistics.  In train mode the normalization runs through
``F.batch_norm`` on the batch statistics (the biased variance), and
autograd gives the backward; the running statistics are updated from a
separate reduction of the detached input.
"""

from __future__ import annotations

import torch
from torch import nn
from torch.nn import functional as F


class BatchNorm2d(nn.BatchNorm2d):
    """BatchNorm over (batch, H, W) of NCHW activations."""

    def __init__(self, num_features: int, momentum: float = 0.1,
                 eps: float = 1e-5):
        super().__init__(num_features, eps=eps, momentum=momentum)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if not self.training:
            return F.batch_norm(x, self.running_mean, self.running_var,
                                self.weight, self.bias, False, 0.0, self.eps)
        with torch.no_grad():
            var, mean = torch.var_mean(x, dim=(0, 2, 3), correction=0)
            m = self.momentum
            self.running_mean.mul_(1.0 - m).add_(mean, alpha=m)
            self.running_var.mul_(1.0 - m).add_(var, alpha=m)
            self.num_batches_tracked.add_(1)
        return F.batch_norm(x, None, None, self.weight, self.bias, True,
                            0.0, self.eps)
