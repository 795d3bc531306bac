"""EPI-Shift: sub-pixel re-centring of light-field view stacks.

Shifting every view of a stack by ``disp * (view_index - center)`` pixels
re-centres the light field on disparity ``disp``.  It feeds the static
``train_shift`` and the 70-member shift ensemble (ESE), where it runs on the
device once per member.

Semantics are those of ``mmlf_tpu.ops.shift``:

  * the fractional shift is decomposed with ``math.modf`` semantics —
    ``shift0 = trunc(s)``, ``alpha = |s - shift0|``,
    ``shift1 = shift0 + copysign(1, shift0)``; ``copysign`` acts on the
    *signed zero* of ``trunc``, so ``s = -0.3`` gives ``shift1 = -1`` while
    ``s = +0.3`` gives ``shift1 = +1``;
  * each view is the lerp of two *circular* rolls,
    ``(1-alpha) * roll(x, shift0) + alpha * roll(x, shift1)``;
  * horizontal views roll along W, vertical along H; the increasing
    diagonal rolls along W by ``+s`` and along H by ``-s``; the decreasing
    diagonal rolls by ``+s`` along both axes.

The shift amounts are host values (the ensemble grid lives on the host), so
the decomposition and the roll indices are computed on the CPU and each roll
is one ``gather`` on the stack's device — no device-to-host sync.
"""

from __future__ import annotations

import torch


def modf_shift_components(s):
    """Decompose shifts ``s`` into (alpha, shift0, shift1) with modf
    semantics.  Returns float32 alpha and int64 shifts, on ``s``'s device
    (CPU for Python or numpy input)."""
    s = torch.as_tensor(s, dtype=torch.float32)
    s0 = torch.trunc(s)
    alpha = torch.abs(s - s0)
    # copysign on the signed zero of trunc reproduces math.copysign(1., -0.)
    s1 = s0 + torch.copysign(torch.ones_like(s0), s0)
    return alpha, s0.long(), s1.long()


def view_offsets(n: int) -> torch.Tensor:
    """Per-view offsets ``i - n//2`` for an ``n``-view stack (float32)."""
    return torch.arange(n, dtype=torch.float32) - float(n // 2)


def roll_lerp_views(stack: torch.Tensor, shifts, axis: int) -> torch.Tensor:
    """Shift every view of a stack by its own fractional amount.

    :param stack: ``(..., n, H, W, C)`` view stack (view axis must be -4)
    :param shifts: ``(n,)`` per-view shift amounts
    :param axis: roll axis, ``-3`` (H) or ``-2`` (W)
    """
    if axis not in (-2, -3):
        raise ValueError('axis must be -2 (W) or -3 (H)')
    alpha, s0, s1 = modf_shift_components(shifts)
    n = alpha.shape[0]

    length = stack.shape[axis]
    pos = torch.arange(length, device=s0.device)
    # roll(x, s)[j] == x[(j - s) mod L]
    idx0 = torch.remainder(pos[None, :] - s0[:, None], length)   # (n, L)
    idx1 = torch.remainder(pos[None, :] - s1[:, None], length)

    if axis == -2:   # roll along W: index shape (n, 1, L, 1)
        view = (n, 1, length, 1)
    else:            # roll along H: index shape (n, L, 1, 1)
        view = (n, length, 1, 1)
    lead = (1,) * (stack.ndim - 4)
    full = stack.shape

    def take(idx):
        idx = idx.reshape(lead + view).to(stack.device).expand(full)
        return torch.gather(stack, stack.ndim + axis, idx)

    a = alpha.to(stack.device, stack.dtype).reshape(n, 1, 1, 1)
    return (1.0 - a) * take(idx0) + a * take(idx1)


def shift_lf(h_views, v_views, i_views, d_views, disp):
    """EPI-Shift all four cross-hair view stacks by disparity ``disp``.

    Stacks are ``(..., n, H, W, C)``; ``disp`` is a host scalar.  Returns
    the four shifted stacks.  Callers correct ground truth (``gt - disp``)
    and the MPI disparity channel themselves.
    """
    n = h_views.shape[-4]
    s = torch.as_tensor(disp, dtype=torch.float32) * view_offsets(n)

    h_out = roll_lerp_views(h_views, s, axis=-2)
    v_out = roll_lerp_views(v_views, s, axis=-3)
    i_out = roll_lerp_views(i_views, s, axis=-2)
    i_out = roll_lerp_views(i_out, -s, axis=-3)
    d_out = roll_lerp_views(d_views, s, axis=-2)
    d_out = roll_lerp_views(d_out, s, axis=-3)
    return h_out, v_out, i_out, d_out
