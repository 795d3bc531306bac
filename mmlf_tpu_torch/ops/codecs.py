"""Regression <-> classification codecs for the discrete (DPP) head.

The class axis is LAST (``(..., H, W, S)``), as in ``mmlf_tpu.ops.codecs``.

Bin grid: ``linspace(start, stop, n_steps)`` with half-open membership
``|bin - x| < step/2`` where ``step = (stop - start) / n_steps`` — the
reference divides by ``n_steps`` (not ``n_steps - 1``), which leaves gaps
between the bins' catchment areas; preserved for parity.
"""

from __future__ import annotations

import numpy as np
import torch


def bin_centers(start: float, stop: float, n_steps: int,
                device=None) -> torch.Tensor:
    """``linspace(start, stop, n_steps)`` in float32, rounded once from
    float64 (so the grid is the same on every device)."""
    grid = np.linspace(start, stop, n_steps).astype(np.float32)
    return torch.from_numpy(grid).to(device)


def reg_to_class(arr: torch.Tensor, start: float, stop: float,
                 n_steps: int) -> torch.Tensor:
    """Continuous values ``(..., H, W)`` -> float one-hot
    ``(..., H, W, n_steps)`` (all-zero if out of range)."""
    step = (stop - start) / n_steps
    bins = bin_centers(start, stop, n_steps, arr.device)
    return (torch.abs(bins - arr[..., None]) < step / 2.0).float()


def class_to_reg(arr: torch.Tensor, start: float, stop: float,
                 n_steps: int) -> torch.Tensor:
    """One-hot (or multi-hot) ``(..., H, W, n_steps)`` -> ``(..., H, W)``
    as the sum of the hot bins' centres."""
    bins = bin_centers(start, stop, n_steps, arr.device)
    return torch.sum(bins * arr, dim=-1)


def mpi_to_weights(mpi: torch.Tensor, start: float, stop: float,
                   n_steps: int) -> torch.Tensor:
    """MPI planes ``(..., K, H, W, 5)`` (alpha at channel 3, disparity at
    4) -> alpha-weighted multi-hot ``(..., H, W, n_steps)``.

    Accumulates plane by plane, so no ``(..., K, H, W, S)`` intermediate
    is materialized.
    """
    step = (stop - start) / n_steps
    bins = bin_centers(start, stop, n_steps, mpi.device)
    planes = torch.movedim(mpi, mpi.ndim - 4, 0)
    out = torch.zeros(planes.shape[1:-1] + (n_steps,), dtype=torch.float32,
                      device=mpi.device)
    for plane in planes:
        hot = torch.abs(bins - plane[..., 4, None]) < step / 2.0
        out += hot.float() * plane[..., 3, None]
    return out
