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

bfloat16 activations (``--bf16``) take ``FusedBatchNorm``'s arithmetic
(``mmlf_tpu/ops/batchnorm.py``): the batch statistics from the fp32
upcast, the normalize as one per-channel affine ``x·bf16(s) + bf16(t)`` in
bf16 (eval mode: the same affine from the running statistics), and the
backward in fp32 with dx cast to bf16 (``_BNApplyBf16``).  The parameters
and running statistics stay float32.

Under ``--remat`` (``models/feed_forward.py``) a block's forward runs again
in the backward; ``recomputing()`` marks that run, and the running
statistics are updated only in the first.

Data parallel (``--mesh_data``, ``parallel/mesh.py``): in train mode the
statistics are the global batch's, as the JAX package's are over its
``data`` mesh.  The mean and the biased variance come from Σx and
Σ(x − mean)² summed over the ranks (``all_reduce_sum``, whose backward
sums the cotangents), and the bf16 backward sums Σdy and Σdy·x over the
ranks for dx; ``affine_from_sums`` sums K3's Σy and Σy² the same way.
Each rank's γ and β gradients stay its own samples' part (the train step
sums every parameter gradient once).  With one rank nothing changes.
"""

from __future__ import annotations

import contextlib
import threading

import torch
from torch import nn
from torch.nn import functional as F

from ..parallel import mesh

# per thread: the backward that recomputes a block may run on another thread
# than a concurrent forward
_STATE = threading.local()


@contextlib.contextmanager
def recomputing():
    """The context of a checkpointed block's second forward: BatchNorm
    leaves its running statistics as the first forward left them."""
    prev = getattr(_STATE, 'recomputing', False)
    _STATE.recomputing = True
    try:
        yield
    finally:
        _STATE.recomputing = prev


class _BNApplyBf16(torch.autograd.Function):
    """The train-mode normalize of a bf16 activation, ``x·bf16(s) +
    bf16(t)`` with ``s = γ·rstd`` and ``t = β − mean·s``, and the canonical
    BatchNorm backward in fp32 (``FusedBatchNorm._bn_apply``): the batch
    mean and rstd take no gradient, their dependence on x is in dx."""

    @staticmethod
    def forward(ctx, x, weight, bias, mean, rstd):
        # mean and rstd are the global batch's under data parallel
        s = weight * rstd
        t = bias - mean * s
        ctx.save_for_backward(x, weight, mean, rstd)
        return x * s.to(x.dtype)[:, None, None] + t.to(x.dtype)[:, None, None]

    @staticmethod
    def backward(ctx, dy):
        x, weight, mean, rstd = ctx.saved_tensors
        n = x.numel() / x.shape[1]
        xf, dyf = x.float(), dy.float()
        sum_dy = dyf.sum((0, 2, 3))
        sum_dy_x = (dyf * xf).sum((0, 2, 3))
        dgamma = rstd * (sum_dy_x - mean * sum_dy)
        g_dy, g_dgamma = sum_dy, dgamma
        if mesh.world() > 1:          # dx takes the global batch's sums
            g_dy, g_dy_x = mesh.all_reduce_(torch.stack([sum_dy, sum_dy_x]))
            g_dgamma = rstd * (g_dy_x - mean * g_dy)
            n = n * mesh.world()
        xhat = (xf - mean[:, None, None]) * rstd[:, None, None]
        dx = (weight * rstd)[:, None, None] * (
            dyf - (g_dy / n)[:, None, None]
            - xhat * (g_dgamma / n)[:, None, None])
        return dx.to(x.dtype), dgamma, sum_dy, None, None


def _global_stats(x: torch.Tensor):
    """The global batch's per-channel mean and biased variance of the
    ranks' NCHW ``x`` (equal shards), two passes, differentiable."""
    n = x.numel() // x.shape[1] * mesh.world()
    mean = mesh.all_reduce_sum(x.sum((0, 2, 3))) / n
    d = x - mean[:, None, None]
    return mean, mesh.all_reduce_sum((d * d).sum((0, 2, 3))) / n


class BatchNorm2d(nn.BatchNorm2d):
    """BatchNorm over (batch, H, W) of NCHW activations."""

    def __init__(self, num_features: int, momentum: float = 0.1,
                 eps: float = 1e-5):
        super().__init__(num_features, eps=eps, momentum=momentum)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if x.dtype == torch.bfloat16:
            return self._forward_bf16(x)
        if not self.training:
            return F.batch_norm(x, self.running_mean, self.running_var,
                                self.weight, self.bias, False, 0.0, self.eps)
        if mesh.world() > 1:
            mean, var = _global_stats(x)
            self._update_running(mean.detach(), var.detach())
            scale = self.weight * torch.rsqrt(var + self.eps)
            return (x - mean[:, None, None]) * scale[:, None, None] + \
                self.bias[:, None, None]
        with torch.no_grad():
            var, mean = torch.var_mean(x, dim=(0, 2, 3), correction=0)
            self._update_running(mean, var)
        return F.batch_norm(x, None, None, self.weight, self.bias, True,
                            0.0, self.eps)

    def _forward_bf16(self, x: torch.Tensor) -> torch.Tensor:
        if not self.training:
            s = self.weight * torch.rsqrt(self.running_var + self.eps)
            t = self.bias - self.running_mean * s
            return x * s.to(x.dtype)[:, None, None] + \
                t.to(x.dtype)[:, None, None]
        with torch.no_grad():
            if mesh.world() > 1:
                mean, var = _global_stats(x.float())
            else:
                var, mean = torch.var_mean(x.float(), dim=(0, 2, 3),
                                           correction=0)
            self._update_running(mean, var)
        return _BNApplyBf16.apply(x, self.weight, self.bias, mean,
                                  torch.rsqrt(var + self.eps))

    @torch.no_grad()
    def _update_running(self, mean: torch.Tensor, var: torch.Tensor):
        if getattr(_STATE, 'recomputing', False):
            return
        m = self.momentum
        self.running_mean.mul_(1.0 - m).add_(mean, alpha=m)
        self.running_var.mul_(1.0 - m).add_(var, alpha=m)
        self.num_batches_tracked.add_(1)

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
        weight and the bias.  Under data parallel the sums and the count
        are the global batch's (``ps`` and ``pss`` summed over the ranks).
        """
        if mesh.world() > 1:
            ps, pss = mesh.all_reduce_sum(torch.stack([ps, pss]))
            count = count * mesh.world()
        mean = ps / count
        var = pss / count - mean * mean
        self._update_running(mean.detach(), var.detach())
        scale = self.weight * torch.rsqrt(var + self.eps)
        return scale, self.bias - mean * scale
