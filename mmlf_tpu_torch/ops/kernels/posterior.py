"""Laplace-mixture posterior of the shift ensemble (kernel K2).

Replaces the Pallas TPU kernel ``mmlf_tpu/ops/pallas/posterior.py``
(``laplace_mixture_posterior``, body ``_mixture_kernel``).  The ensemble's
per-pixel posterior is a K-member mixture evaluated on a K-bin grid:

    out[p, j] = (1/K) Σ_k exp(-|bins[j] − m[k, p]| / v[k, p]) / (2·v[k, p])

with ``v = exp(logvar)`` used as the Laplace *scale* (reference quirk).

On a CUDA tensor the wrapper launches the hand-written kernel
``csrc/posterior.cu`` (its note gives the bound on an H100: the
exponentials on the special-function units); on a CPU tensor it takes the
plain PyTorch version beside it.  There is no fallback: a build or launch
error raises.  ``laplace_mixture_posterior.launches`` counts kernel
launches.

Unlike the TPU kernel, whose output is bins-first ``(Kb, P)`` and is moved
to bins-last afterwards, the kernel writes the bins-last ``(P, Kb)`` layout
that ``ensemble_posterior`` returns.
"""

from __future__ import annotations

import ctypes

import torch

from ..codecs import bin_centers
from . import build


def plain_mixture_posterior(means: torch.Tensor, scales: torch.Tensor,
                            bins: torch.Tensor) -> torch.Tensor:
    """Plain PyTorch version: accumulate ``laplacian(bins, m_k, v_k)``
    over the members.  ``(K, P), (K, P), (Kb,) -> (P, Kb)``."""
    k, p = means.shape
    out = torch.zeros((p, bins.shape[0]), dtype=torch.float32,
                      device=means.device)
    for m, v in zip(means, scales):
        out += torch.exp(-torch.abs(bins - m[:, None]) / v[:, None]) \
            / (2.0 * v[:, None])
    return out / float(k)


def _launch(means, scales, bins, out) -> None:
    lib = build.load('posterior')
    fn = lib.mmlf_posterior_launch
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int, ctypes.c_longlong,
                                           ctypes.c_int, ctypes.c_int,
                                           ctypes.c_void_p]
    stream = torch.cuda.current_stream(means.device).cuda_stream
    err = fn(means.data_ptr(), scales.data_ptr(), bins.data_ptr(),
             out.data_ptr(), means.shape[0], means.shape[1], bins.shape[0],
             means.device.index, stream)
    build.check(lib, err, 'mixture posterior kernel launch')


def max_bins() -> int:
    """The largest bin count the CUDA kernel takes in one launch."""
    lib = build.load('posterior')
    lib.mmlf_posterior_max_bins.restype = ctypes.c_int
    return lib.mmlf_posterior_max_bins()


def laplace_mixture_posterior(means: torch.Tensor, scales: torch.Tensor,
                              bins: torch.Tensor) -> torch.Tensor:
    """Mixture posterior over a bin grid.

    :param means: ``(K, P)`` float32 member locations (pixels flattened)
    :param scales: ``(K, P)`` float32 member Laplace scales
    :param bins: ``(Kb,)`` float32 evaluation grid
    :returns: ``(P, Kb)`` mixture density, mean over members (bins last)
    """
    if means.ndim != 2 or scales.shape != means.shape or bins.ndim != 1:
        raise ValueError(f'expected means/scales (K, P) and bins (Kb,), got '
                         f'{tuple(means.shape)}, {tuple(scales.shape)}, '
                         f'{tuple(bins.shape)}')
    for name, t in (('means', means), ('scales', scales), ('bins', bins)):
        if t.dtype != torch.float32:
            raise TypeError(f'{name} must be float32, got {t.dtype}')
        if t.device != means.device:
            raise ValueError(f'{name} is on {t.device}, means on '
                             f'{means.device}')

    if means.device.type == 'cpu':
        return plain_mixture_posterior(means, scales, bins)
    if means.device.type != 'cuda':
        raise ValueError(f'no mixture posterior for device {means.device}')

    if bins.shape[0] > max_bins():
        raise ValueError(f'{bins.shape[0]} bins exceed the kernel\'s '
                         f'{max_bins()}')
    means, scales, bins = (t.contiguous() for t in (means, scales, bins))
    out = torch.empty((means.shape[1], bins.shape[0]), dtype=torch.float32,
                      device=means.device)
    _launch(means, scales, bins, out)
    laplace_mixture_posterior.launches += 1
    return out


laplace_mixture_posterior.launches = 0


def ensemble_posterior(means: torch.Tensor, logvars: torch.Tensor,
                       disp_min: float, disp_max: float) -> torch.Tensor:
    """ESE posterior from stacked member outputs.

    :param means: ``(K, b, H, W)`` member means (already shift-corrected)
    :param logvars: ``(K, b, H, W)`` member logvars
    :returns: ``(b, H, W, K)`` posterior over ``linspace(min, max, K)``
    """
    k = means.shape[0]
    spatial = tuple(means.shape[1:])
    bins = bin_centers(disp_min, disp_max, k, means.device)
    post = laplace_mixture_posterior(means.reshape(k, -1),
                                     torch.exp(logvars).reshape(k, -1),
                                     bins)                       # (P, K)
    return post.reshape(spatial + (k,))
