"""Shift-Ensemble (ESE): weight-shared ensemble over a disparity grid.

For every ``shift_disp`` in ``arange(disp_min, disp_max, disp_step)``
(float32; 70 members at the defaults), EPI-shift the input light field on
the device, run the wrapped UPR model, and collect ``mean + shift_disp`` and
``logvar``.  The output disparity is the member with the per-pixel minimum
logvar (strict ``<``: the first member wins ties).  The posterior is a
mixture of Laplacians over a ``linspace(disp_min, disp_max, K)`` bin grid,
with ``exp(logvar)`` as the Laplace scale — computed by the mixture kernel
(``ops/kernels/posterior.py``) from the stacked members.

The JAX package runs the members as one ``lax.scan``; here they are a
Python loop of eager forwards, each writing its slice of the ``(K, b, H, W)``
member stacks in place.  ``ensemble_forward_sharded`` splits the members
over the ranks of a process group (``--mesh_ensemble``).
"""

from __future__ import annotations

import numpy as np
import torch

from ..ops.codecs import bin_centers
from ..ops.kernels.posterior import (ensemble_posterior,
                                     laplace_mixture_posterior)
from ..ops.shift import shift_lf
from ..parallel import mesh
from ..trace import span


def ensemble_grid(disp_min: float, disp_max: float,
                  disp_step: float) -> np.ndarray:
    """The member shift grid, ``arange(disp_min, disp_max, disp_step)``
    in float32 (its "zero" member at the defaults is about -3e-6)."""
    return np.arange(disp_min, disp_max, disp_step, dtype=np.float32)


@torch.no_grad()
def ensemble_forward(model, h_views, v_views, i_views, d_views,
                     disp_min: float, disp_max: float, disp_step: float,
                     member_offsets=None) -> dict:
    """Run the shift ensemble.

    :param model: ``fn(h, v, i, d) -> output dict`` with ``mean`` and
        ``logvar`` (the UPR model in eval mode)
    :param member_offsets: optional ``(K,)`` per-member logvar offsets
        (validate/calibrate.py): every member's logvar becomes
        ``logvar_k - offsets[k]`` before selection, the member dump and
        the mixture posterior.  None = reference-exact.
    :returns: dict with ``mean``, ``logvar`` (min-logvar member), ``means``,
        ``logvars`` (``(K, b, H, W)`` stacked members, reference layout) and
        ``posterior`` (``(b, H, W, K)`` Laplace mixture, bins last)
    """
    shifts = ensemble_grid(disp_min, disp_max, disp_step)
    n_members = shifts.shape[0]
    offsets = _offsets(member_offsets, n_members)

    with span('mmlf.val.members'):
        means, logvars, best_lv, best_mean = _run_members(
            model, (h_views, v_views, i_views, d_views), shifts, offsets,
            n_members)
        posterior = ensemble_posterior(means, logvars, disp_min, disp_max)
    return {
        'mean': best_mean,
        'logvar': best_lv,
        'means': means,
        'logvars': logvars,
        'posterior': posterior,
    }


def _offsets(member_offsets, k: int) -> np.ndarray:
    offsets = (np.zeros(k, np.float32) if member_offsets is None
               else np.asarray(member_offsets, np.float32))
    if offsets.shape != (k,):
        raise ValueError(f'member_offsets must have shape ({k},), '
                         f'got {offsets.shape}')
    return offsets


def _run_members(model, stacks, shifts, offsets, n_slots: int):
    """The members of ``shifts`` (the serial loop's body) into ``(n_slots,
    b, H, W)`` stacks shaped like the model's ``mean`` (slots past the
    members hold mean 0, logvar +inf): each member's shift-corrected mean
    and offset logvar, and the running min-logvar selection (strict
    ``<``: the first member wins ties).  Returns ``(means, logvars,
    best_lv, best_mean)``."""
    means = logvars = best_lv = best_mean = None
    for j, (shift_disp, offset) in enumerate(zip(shifts, offsets)):
        out = model(*shift_lf(*stacks, shift_disp))
        if means is None:
            means, logvars, best_lv, best_mean = _slots(out['mean'].shape,
                                                        n_slots,
                                                        out['mean'].device)
        torch.add(out['mean'], float(shift_disp), out=means[j])
        torch.sub(out['logvar'], float(offset), out=logvars[j])

        take = logvars[j] < best_lv
        best_lv = torch.where(take, logvars[j], best_lv)
        best_mean = torch.where(take, means[j], best_mean)
    if means is None:                  # a rank with dummy members only
        b, _, hh, ww, _ = stacks[0].shape
        means, logvars, best_lv, best_mean = _slots((b, hh, ww), n_slots,
                                                    stacks[0].device)
    return means, logvars, best_lv, best_mean


def _slots(shape, n_slots: int, dev):
    means = torch.zeros((n_slots,) + tuple(shape), dtype=torch.float32,
                        device=dev)
    return (means, torch.full_like(means, float('inf')),
            torch.full(tuple(shape), float('inf'), dtype=torch.float32,
                       device=dev),
            torch.zeros(tuple(shape), dtype=torch.float32, device=dev))


@torch.no_grad()
def ensemble_forward_sharded(model, h_views, v_views, i_views, d_views,
                             disp_min: float, disp_max: float,
                             disp_step: float, need_members: bool = True,
                             member_offsets=None) -> dict:
    """The shift ensemble with its members split over the ranks of the
    process group (``--mesh_ensemble``); every rank calls it with the same
    inputs and gets the same outputs, those of ``ensemble_forward``.

    The counterpart of the JAX package's ``ensemble_forward_sharded``: the
    grid of K members is padded to a multiple of the rank count with
    dummy members (logvar +inf, posterior weight 0); rank r runs the real
    ones of its ``ceil(K/n)`` contiguous slots with the serial loop's body
    (a dummy needs no forward).  The selection gathers every rank's
    ``(best_lv, best_mean)`` and takes the argmin over ranks, the lowest
    rank on ties: ranks hold contiguous members, so this is the serial
    loop's strict ``<``.  With ``need_members`` (what the validate CLI
    uses: it writes the member dump) the member stacks are gathered,
    trimmed to K and the posterior is kernel K2 once on the full stack,
    on every rank; without, each rank's K2 runs on its real members only,
    is scaled by ``k_r / K`` and summed over the ranks (the JAX ``psum``),
    and ``means`` / ``logvars`` are None.  ``member_offsets`` (K,) shift
    the logvars as in ``ensemble_forward``.
    """
    shifts = ensemble_grid(disp_min, disp_max, disp_step)
    k = shifts.shape[0]
    offsets = _offsets(member_offsets, k)
    start, stop, per = mesh.member_share(k, mesh.rank(), mesh.world())

    means, logvars, best_lv, best_mean = _run_members(
        model, (h_views, v_views, i_views, d_views), shifts[start:stop],
        offsets[start:stop], per)

    all_lv = mesh.gather_dim(best_lv[None], 0)               # (n, b, H, W)
    all_mean = mesh.gather_dim(best_mean[None], 0)
    idx = torch.argmin(all_lv, dim=0, keepdim=True)          # first on ties
    best_lv = torch.take_along_dim(all_lv, idx, dim=0)[0]
    best_mean = torch.take_along_dim(all_mean, idx, dim=0)[0]

    if need_members:
        means = mesh.gather_dim(means, 0)[:k]
        logvars = mesh.gather_dim(logvars, 0)[:k]
        posterior = ensemble_posterior(means, logvars, disp_min, disp_max)
    else:
        k_r = stop - start
        posterior = torch.zeros(best_lv.shape + (k,), dtype=torch.float32,
                                device=best_lv.device)
        if k_r:
            bins = bin_centers(disp_min, disp_max, k, best_lv.device)
            post = laplace_mixture_posterior(
                means[:k_r].reshape(k_r, -1),
                torch.exp(logvars[:k_r]).reshape(k_r, -1), bins)
            posterior = post.reshape(posterior.shape) * (k_r / k)
        posterior = mesh.all_reduce_(posterior)
        means = logvars = None
    return {
        'mean': best_mean,
        'logvar': best_lv,
        'means': means,
        'logvars': logvars,
        'posterior': posterior,
    }
