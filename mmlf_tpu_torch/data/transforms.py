"""Host-side (numpy) transforms over the 9-tuple sample.

What the ported paths need: the static ``Shift`` (``train_shift``), the
numpy EPI-Shift helpers it and the synthetic-scene generator use, and the
random colour matrix the training pipeline samples.
The sample is ``(h_views, v_views, i_views, d_views, center, gt, mpi, mask,
index)`` with stacks ``(n, H, W, 3)``, gt ``(H, W)``, MPI ``(K, H, W, 5)``.
"""

from __future__ import annotations

import numpy as np


def np_roll_lerp_views(stack: np.ndarray, shifts: np.ndarray,
                       axis: int) -> np.ndarray:
    """Numpy twin of ``ops.shift.roll_lerp_views`` for host pipelines."""
    shifts = np.asarray(shifts, dtype=np.float32)
    s0 = np.trunc(shifts)
    alpha = np.abs(shifts - s0)
    s1 = s0 + np.copysign(np.float32(1.0), s0)
    s0 = s0.astype(np.int64)
    s1 = s1.astype(np.int64)

    length = stack.shape[axis]
    pos = np.arange(length)
    idx0 = (pos[None, :] - s0[:, None]) % length        # (n, L)
    idx1 = (pos[None, :] - s1[:, None]) % length

    if axis == -2:
        sl0 = idx0[:, None, :, None]
        sl1 = idx1[:, None, :, None]
    elif axis == -3:
        sl0 = idx0[:, :, None, None]
        sl1 = idx1[:, :, None, None]
    else:
        raise ValueError('axis must be -2 (W) or -3 (H)')
    a = alpha[:, None, None, None]

    g0 = np.take_along_axis(stack, sl0, axis=axis)
    g1 = np.take_along_axis(stack, sl1, axis=axis)
    return ((1.0 - a) * g0 + a * g1).astype(stack.dtype)


def np_shift_lf(h, v, i, d, disp: float):
    """Numpy EPI-Shift of the four stacks (see ops/shift.py)."""
    n = h.shape[-4]
    s = np.float32(disp) * (np.arange(n, dtype=np.float32) - n // 2)
    h = np_roll_lerp_views(h, s, axis=-2)
    v = np_roll_lerp_views(v, s, axis=-3)
    i = np_roll_lerp_views(i, s, axis=-2)
    i = np_roll_lerp_views(i, -s, axis=-3)
    d = np_roll_lerp_views(d, s, axis=-2)
    d = np_roll_lerp_views(d, s, axis=-3)
    return h, v, i, d


class Shift:
    """Sub-pixel EPI-Shift; GT and MPI disparity corrected by -disp."""

    def __init__(self, disp: float):
        self.disp = float(disp)

    def __call__(self, data):
        data = list(data)
        data[0], data[1], data[2], data[3] = np_shift_lf(
            data[0], data[1], data[2], data[3], self.disp)
        if len(data) > 5:
            data[5] = data[5] - np.float32(self.disp)
        if len(data) > 6:
            data[6] = data[6].copy()
            data[6][..., 4] -= np.float32(self.disp)
        return tuple(data)


def random_color_matrix(rng: np.random.Generator) -> np.ndarray:
    """The reference's random row/column-stochastic 3×3 colour mix, drawn
    from ``rng`` in the order of ``mmlf_tpu.data.transforms`` (the same
    generator state gives the same matrix)."""
    def u(a, b):
        return float(rng.uniform(a, b))

    m = np.zeros((3, 3))
    m[0, 0] = u(0.0, 1.0)
    m[0, 1] = u(0.0, 1.0 - m[0, 0])
    m[1, 0] = u(0.0, 1.0 - m[0, 0])
    m[1, 1] = u(0.0, 1.0 - max(m[0, 1], m[1, 0]))
    m[0, 2] = 1.0 - m[0, 0] - m[0, 1]
    m[1, 2] = 1.0 - m[1, 0] - m[1, 1]
    m[2, 0] = 1.0 - m[0, 0] - m[1, 0]
    m[2, 1] = 1.0 - m[0, 1] - m[1, 1]
    m[2, 2] = m[0, 0] + m[0, 1] + m[1, 0] + m[1, 1] - 1.0
    return m.astype(np.float32)
