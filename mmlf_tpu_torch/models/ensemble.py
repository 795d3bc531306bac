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
member stacks in place.
"""

from __future__ import annotations

import numpy as np
import torch

from ..ops.kernels.posterior import ensemble_posterior
from ..ops.shift import shift_lf


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
    offsets = (np.zeros(n_members, np.float32) if member_offsets is None
               else np.asarray(member_offsets, np.float32))
    if offsets.shape != (n_members,):
        raise ValueError(f'member_offsets must have shape ({n_members},), '
                         f'got {offsets.shape}')

    b, _, hh, ww, _ = h_views.shape
    dev = h_views.device
    means = torch.empty((n_members, b, hh, ww), dtype=torch.float32,
                        device=dev)
    logvars = torch.empty_like(means)
    best_lv = torch.full((b, hh, ww), float('inf'), dtype=torch.float32,
                         device=dev)
    best_mean = torch.zeros((b, hh, ww), dtype=torch.float32, device=dev)

    for k, (shift_disp, offset) in enumerate(zip(shifts, offsets)):
        hs, vs, is_, ds = shift_lf(h_views, v_views, i_views, d_views,
                                   shift_disp)
        out = model(hs, vs, is_, ds)
        torch.add(out['mean'], float(shift_disp), out=means[k])
        torch.sub(out['logvar'], float(offset), out=logvars[k])

        take = logvars[k] < best_lv
        best_lv = torch.where(take, logvars[k], best_lv)
        best_mean = torch.where(take, means[k], best_mean)

    posterior = ensemble_posterior(means, logvars, disp_min, disp_max)
    return {
        'mean': best_mean,
        'logvar': best_lv,
        'means': means,
        'logvars': logvars,
        'posterior': posterior,
    }
