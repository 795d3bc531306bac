"""Masked loss library + BadPix metric.

The counterparts of ``mmlf_tpu.losses``.  Every loss takes the model's
output dict, a target and a mask; means are normalized by the mask count
(``sum(values * mask) / sum(mask)``), falling back to the plain masked sum
— which is zero — when the mask is empty.

Layouts: targets and masks ``(b, H, W)``; MPI targets ``(b, K, H, W, 5)``
(alpha at [..., 3], disparity at [..., 4]); discrete targets and scores
bins-last ``(b, H, W, S)``.

Quirks kept from the reference: ``masked_cross_entropy`` ReLUs the logits
before the soft-target cross-entropy; the "improved" uncertainty losses
add a ``-logvar`` out-of-range term and average the two renormalized
terms.  Where the reference would divide by zero on an empty out-of-range
mask, the scale is 0 instead (as in the JAX package).
"""

from __future__ import annotations

import torch


def _masked_mean(values: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """sum(values * mask) / count, or the (zero) masked sum if count == 0."""
    mask_f = mask.float()
    count = torch.sum(mask_f)
    total = torch.sum(values * mask_f)
    return torch.where(count > 0, total / torch.clamp(count, min=1.0), total)


def _scale(count: torch.Tensor, numel: float, empty: float) -> torch.Tensor:
    """numel / count, or ``empty`` when count == 0."""
    return torch.where(count > 0, numel / torch.clamp(count, min=1.0),
                       torch.full_like(count, empty))


def masked_l1(output: dict, target: torch.Tensor,
              mask: torch.Tensor) -> torch.Tensor:
    """L1 on masked pixels."""
    return _masked_mean(torch.abs(output['mean'] - target), mask)


def masked_mse(output: dict, target: torch.Tensor,
               mask: torch.Tensor) -> torch.Tensor:
    """MSE on masked pixels."""
    return _masked_mean((output['mean'] - target) ** 2.0, mask)


def masked_badpix(output: dict, target: torch.Tensor, mask: torch.Tensor,
                  t: float = 0.07) -> torch.Tensor:
    """BadPix(t): fraction of masked pixels with |err| > t."""
    bad = (torch.abs(output['mean'] - target) > t).float()
    return _masked_mean(bad, mask)


def multi_masked_l1(output: dict, mpi: torch.Tensor,
                    mask: torch.Tensor) -> torch.Tensor:
    """Alpha-weighted multi-plane L1; ``mpi`` is ``(b, K, H, W, 5)``."""
    diff = torch.abs(output['mean'][:, None] - mpi[..., 4]) * mpi[..., 3]
    return _masked_mean(torch.sum(diff, dim=1), mask)


def multi_masked_mse(output, mpi, mask):
    raise NotImplementedError()  # parity: reference loss.py:134


def masked_cross_entropy(output: dict, target: torch.Tensor,
                         mask: torch.Tensor) -> torch.Tensor:
    """Softmax CE with soft targets ``(b, H, W, S)`` on ReLU'd logits,
    in log space."""
    scores = torch.clamp(output['scores'], min=0.0)
    loss = torch.logsumexp(scores, dim=-1) - torch.sum(scores * target,
                                                       dim=-1)
    return _masked_mean(loss, mask)


def uncertainty_mse(output: dict, target: torch.Tensor,
                    mask: torch.Tensor) -> torch.Tensor:
    """Kendall & Gal heteroscedastic MSE."""
    loss = 0.5 * torch.exp(-output['logvar']) * \
        (output['mean'] - target) ** 2.0
    return _masked_mean(loss + 0.5 * output['logvar'], mask)


def multi_uncertainty_mse(output, mpi, mask):
    raise NotImplementedError()  # parity: reference loss.py:225


def logvar_anchor(output: dict, target, mpi, mask: torch.Tensor,
                  mask_padding=None, multimodal: bool = False,
                  eps: float = 1e-6) -> torch.Tensor:
    """Calibration anchor of the uncertainty head
    (``--train_logvar_anchor``): ``(logvar - detach(log max(|err|, eps)))²``
    on in-range masked pixels.  For the multimodal loss the error is the
    alpha-weighted plane distance and pixels with ``sum w < 0.01`` are
    left out."""
    logvar = output['logvar']
    if multimodal:
        weights = mpi[..., 3]
        dists = torch.abs(output['mean'][:, None] - mpi[..., 4])
        wsum = torch.sum(weights, dim=1)
        err = torch.sum(dists * weights, dim=1) / torch.clamp(wsum, min=eps)
        in_range = (wsum >= 0.01).float()
    else:
        err = torch.abs(output['mean'] - target)
        in_range = (mask_padding.float() if mask_padding is not None
                    else 1.0)
    target_lv = torch.log(torch.clamp(err, min=eps)).detach()
    sq = (logvar - target_lv) ** 2.0
    return _masked_mean(sq, mask.float() * in_range)


def uncertainty_l1(output: dict, target: torch.Tensor,
                   mask: torch.Tensor) -> torch.Tensor:
    """Heteroscedastic L1."""
    loss = torch.exp(-output['logvar']) * torch.abs(output['mean'] - target)
    return _masked_mean(loss + output['logvar'], mask)


def improved_uncertainty_l1(output: dict, target: torch.Tensor,
                            mask: torch.Tensor,
                            mask_padding=None) -> torch.Tensor:
    """Heteroscedastic L1 with an out-of-range confidence term: where GT is
    absent (``mask_padding == 0``) high predicted variance is rewarded via
    ``-logvar``; both terms are renormalized to the pixel count and
    averaged."""
    loss = torch.exp(-output['logvar']) * torch.abs(output['mean'] - target)
    loss = loss + output['logvar']
    if mask_padding is not None:
        mp = mask_padding.float()
        numel = float(mp.numel())
        loss = loss * mp * _scale(torch.sum(mp), numel, 1.0)
        mask_oor = 1.0 - mp
        loss_oor = -output['logvar'] * mask_oor * \
            _scale(torch.sum(mask_oor), numel, 0.0)
        loss = (loss + loss_oor) / 2.0
    return _masked_mean(loss, mask)


def _plane_uncertainty_l1(output: dict, mpi: torch.Tensor) -> torch.Tensor:
    """Per-plane heteroscedastic L1 ``(b, K, H, W)``."""
    loss = torch.exp(-output['logvar'])[:, None] * \
        torch.abs(output['mean'][:, None] - mpi[..., 4])
    return loss + output['logvar'][:, None]


def multi_uncertainty_l1(output: dict, mpi: torch.Tensor,
                         mask: torch.Tensor) -> torch.Tensor:
    """Alpha-weighted heteroscedastic L1."""
    loss = torch.sum(_plane_uncertainty_l1(output, mpi) * mpi[..., 3], dim=1)
    return _masked_mean(loss, mask)


def improved_multi_uncertainty_l1(output: dict, mpi: torch.Tensor,
                                  mask: torch.Tensor,
                                  mask_padding=None) -> torch.Tensor:
    """Multimodal heteroscedastic L1 with the out-of-range term.
    ``mask_padding`` is accepted for call-site parity and unused, as in
    the reference."""
    weights = mpi[..., 3]
    wsum = torch.sum(weights, dim=1)                     # (b, H, W)
    loss = torch.sum(_plane_uncertainty_l1(output, mpi) * weights,
                     dim=1) / torch.mean(wsum)
    mask_oor = (wsum < 0.01).float()
    loss_oor = -output['logvar'] * mask_oor * \
        _scale(torch.sum(mask_oor), float(mask_oor.numel()), 0.0)
    return _masked_mean((loss + loss_oor) / 2.0, mask)


def information_bottleneck(output: dict, target: torch.Tensor,
                           beta: float) -> torch.Tensor:
    """The INN's information-bottleneck loss (``models/inn.py``).

    ``dists`` and the one-hot ``target`` are channel-last ``(b, H, W,
    K)``.  The incoming ``jac`` is already normalised by ``dims·H·W`` in
    the INN forward and is divided by it again here, as in the JAX
    package (a reference quirk on both sides).  The loss ignores the
    mask, as the reference's does."""
    beta_nll = 1.0 / (1.0 + beta)
    beta_cat_ce = beta / (1.0 + beta)
    zixels, jac, mu, dists = (output[k] for k in
                              ('zixels', 'jac', 'mu', 'dists'))
    h, w = zixels.shape[1], zixels.shape[2]
    dims = mu.shape[-1]
    jac = jac.reshape(-1, 1, 1) / (dims * w * h)
    nll = (-torch.logsumexp(-0.5 * dists, dim=-1) - jac) / dims
    cat_ce = -torch.sum(torch.log_softmax(-0.5 * dists, dim=-1) * target,
                        dim=-1)
    return beta_nll * torch.mean(nll) + beta_cat_ce * torch.mean(cat_ce)
