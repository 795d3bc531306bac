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

The fused trunk of ``--pallas_trunk`` (``models/pallas_trunk.py``) takes
the batch statistics from kernel K3's per-channel sums instead:
``affine_from_sums`` turns them into the next block's input affine and
updates the same running buffers.
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

    def affine_from_sums(self, ps: torch.Tensor, pss: torch.Tensor,
                         count: float):
        """Train-mode BatchNorm from per-channel sums, as ``(scale,
        shift)`` of ``y ↦ scale·y + shift``.

        ``ps`` and ``pss`` are Σy and Σy² over the ``count`` pixels of the
        batch.  The statistics are ``mean = ps / count`` and the biased
        ``var = pss / count − mean²`` (the formula of the JAX package's
        ``--pallas_trunk``, not ``var_mean``); the running statistics and
        ``num_batches_tracked`` are updated from the detached values as
        ``forward`` updates them.  Gradients flow to ``ps``, ``pss``, the
        weight and the bias.
        """
        mean = ps / count
        var = pss / count - mean * mean
        with torch.no_grad():
            m = self.momentum
            self.running_mean.mul_(1.0 - m).add_(mean, alpha=m)
            self.running_var.mul_(1.0 - m).add_(var, alpha=m)
            self.num_batches_tracked.add_(1)
        scale = self.weight * torch.rsqrt(var + self.eps)
        return scale, self.bias - mean * scale
