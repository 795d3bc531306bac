"""Masked metrics of the validate path: MSE and BadPix.

Means are normalized by the mask count (``sum(values * mask) /
sum(mask)``), falling back to the plain masked sum — which is zero — when
the mask is empty.  The training losses are not ported yet (ROADMAP.md,
Queue 1: the train step).
"""

from __future__ import annotations

import torch


def _masked_mean(values: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """sum(values * mask) / count, or the (zero) masked sum if count == 0."""
    mask_f = mask.float()
    count = torch.sum(mask_f)
    total = torch.sum(values * mask_f)
    return torch.where(count > 0, total / torch.clamp(count, min=1.0), total)


def masked_mse(output: dict, target: torch.Tensor,
               mask: torch.Tensor) -> torch.Tensor:
    """MSE on masked pixels."""
    return _masked_mean((output['mean'] - target) ** 2.0, mask)


def masked_badpix(output: dict, target: torch.Tensor, mask: torch.Tensor,
                  t: float = 0.07) -> torch.Tensor:
    """BadPix(t): fraction of masked pixels with |err| > t."""
    bad = (torch.abs(output['mean'] - target) > t).float()
    return _masked_mean(bad, mask)
