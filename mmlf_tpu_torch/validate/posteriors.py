"""Posterior discretization + distribution metrics (KLD / NLL).

The PyTorch counterparts of ``mmlf_tpu.validate.posteriors``, with the
disparity-bin axis LAST (``(..., S)``), transposed only when artifacts are
saved.

Parity quirks preserved on purpose:
  * ``exp(logvar)`` is used as the Laplace *scale* everywhere;
  * ``nll_discrete`` normalizes the posterior by ``sum * 7.0``;
  * the ESE path passes *already-exponentiated* logvars into
    ``lmm_to_discrete``, which exponentiates again — the double exp is kept
    so ESE KLD numbers stay comparable.
Normalizations use ``keepdim`` so they hold for any batch size.
"""

from __future__ import annotations

import numpy as np
import torch

EPS = 1e-5


def _edges(x_min: float, x_max: float, n_bins: int, device) -> torch.Tensor:
    step = (x_max - x_min) / n_bins
    grid = np.linspace(x_min - step / 2.0, x_max + step / 2.0, n_bins + 1)
    return torch.from_numpy(grid.astype(np.float32)).to(device)


def prob_laplace(disp, mean, logvar):
    """Laplace density of ``disp`` bins ``(..., S)`` given per-pixel
    mean/logvar."""
    var = torch.exp(logvar)[..., None]
    return torch.exp(-torch.abs(mean[..., None] - disp) / var) / var / 2.0


def cdf_laplace(disp, mean, var):
    """Laplace CDF (scale ``var``), elementwise."""
    lo = torch.exp((disp - mean) / var) / 2.0
    hi = 1.0 - torch.exp(-(disp - mean) / var) / 2.0
    return torch.where(disp < mean, lo, hi)


def laplace_to_discrete(n_bins: int, x_min: float, x_max: float,
                        mean, logvar):
    """Integrate a Laplace posterior over ``n_bins`` equal bins;
    returns ``(..., n_bins)`` probabilities."""
    edges = _edges(x_min, x_max, n_bins, mean.device)
    var = torch.exp(logvar)[..., None]
    cdf = cdf_laplace(edges, mean[..., None], var)
    return cdf[..., 1:] - cdf[..., :-1]


def lmm_to_discrete(n_bins: int, x_min: float, x_max: float,
                    means, logvars):
    """Discretize a Laplace mixture (ESE members).

    :param means: ``(K, ...)`` member means
    :param logvars: ``(K, ...)`` member "logvars" — the validate CLI passes
        exp(logvar) here and this function exponentiates again (quirk kept)
    """
    out = torch.zeros(tuple(means.shape[1:]) + (n_bins,),
                      dtype=torch.float32, device=means.device)
    for m, lv in zip(means, logvars):
        out += laplace_to_discrete(n_bins, x_min, x_max, m, lv)
    return out / means.shape[0]


def mean_to_discrete(n_bins: int, x_min: float, x_max: float, mean):
    """One-hot discretization of a point estimate (BASE head)."""
    step = (x_max - x_min) / n_bins
    grid = np.linspace(x_min, x_max, n_bins).astype(np.float32)
    bins = torch.from_numpy(grid).to(mean.device)
    return (torch.abs(bins - mean[..., None]) < step / 2.0).float()


def nll_laplace(mpi, mean, logvar, mask=None):
    """Laplace NLL of the MPI modes under the predicted distribution.

    :param mpi: ``(b, K, H, W, 5)``
    """
    disp = mpi[..., 4]                       # (b, K, H, W)
    alpha = mpi[..., 3]
    var = torch.exp(logvar)[:, None]
    prob = torch.exp(-torch.abs(mean[:, None] - disp) / var) / var / 2.0 + EPS
    nllh = torch.sum(alpha * -torch.log(prob), dim=1)
    if mask is not None:
        return torch.sum(nllh * mask) / torch.sum(mask)
    return torch.mean(nllh)


def nll_discrete(weights, posterior, mask=None):
    """Discrete NLL with the reference's ``/7.0`` normalization quirk.

    :param weights: ``(..., S)`` GT bin weights
    :param posterior: ``(..., S)`` predicted bin probabilities
    """
    weights = weights + EPS
    posterior = posterior + EPS
    weights = weights / torch.sum(weights, -1, keepdim=True)
    posterior = posterior / (torch.sum(posterior, -1, keepdim=True) * 7.0)
    nllh = torch.sum(weights * -torch.log(posterior), dim=-1)
    if mask is not None:
        return torch.sum(nllh * mask) / torch.sum(mask)
    return torch.mean(nllh)


def likelihood_laplace(mpi, mean, logvar, mask):
    """Alpha-weighted likelihood of MPI modes."""
    disp = mpi[..., 4]
    alpha = mpi[..., 3]
    var = torch.exp(logvar)[:, None]
    prob = torch.exp(-torch.abs(mean[:, None] - disp) / var) / var / 2.0 + EPS
    prob = prob / torch.sum(prob, dim=1, keepdim=True)
    lh = torch.sum(alpha * prob, dim=1) * mask
    return torch.sum(lh) / torch.sum(mask)


def multimodal_mask(mpi, threshold: float = 0.3):
    """1.0 where more than one MPI plane has alpha above ``threshold``."""
    alpha = mpi[..., 3]
    return (torch.sum(alpha > threshold, dim=1) > 1).float()


def kl_divergence(dist, dist_gt, mask=None):
    """KL(gt || predicted) over the bin axis, optionally mask-averaged."""
    dist = dist + EPS
    dist_gt = dist_gt + EPS
    dist = dist / torch.sum(dist, -1, keepdim=True)
    dist_gt = dist_gt / torch.sum(dist_gt, -1, keepdim=True)
    kld = torch.sum(dist_gt * torch.log(dist_gt / dist), dim=-1)
    if mask is None:
        return torch.mean(kld)
    return torch.sum(kld * mask) / torch.sum(mask)
