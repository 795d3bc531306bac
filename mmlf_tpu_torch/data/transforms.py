"""Host-side (numpy) transforms over the 9-tuple sample.

The counterpart of ``mmlf_tpu.data.transforms``: the reference's transform
classes for dataset-style use (validation preprocessing, tests, offline
tooling).  The training pipelines compute the same chain themselves
(``data/pipeline.py``) and use only ``np_shift_lf`` (the static
``train_shift``) and ``random_color_matrix`` of this module.

The sample is ``(h_views, v_views, i_views, d_views, center, gt, mpi, mask,
index)`` with stacks ``(n, H, W, 3)``, centre ``(H, W, 3)``, gt ``(H, W)``,
MPI ``(K, H, W, 5)`` and mask ``(H, W)``.

The rules of the reference hold, quirks included: geometric ops touch every
image-like field, colour ops only the four stacks and the centre, and
``Rotate90`` rotates stacks, centre, gt and MPI but not the mask.  The
random transforms draw from the stdlib ``random`` and the global
``np.random`` state in the JAX module's order, so a chain under the same
seeded globals gives the same sample.  ``Zoom`` is a nearest-neighbour
rescale computed here with the index rule of ``scipy.ndimage.zoom(order=0)``
(the JAX module calls scipy; the port imports no scipy).
"""

from __future__ import annotations

import random

import numpy as np

STACKS = slice(0, 4)      # h, v, i, d
COLOR_FIELDS = 5          # stacks + center get colour transforms
GEOM_FIELDS = 7           # + gt, mpi get rot90 (mask excluded: quirk)


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


def _spatial_fields(data):
    """``(index, H axis)`` pairs of the fields that geometric ops touch."""
    out = []
    for idx in range(min(len(data), 8)):
        arr = data[idx]
        if arr is None or np.ndim(arr) < 2:
            continue
        # stacks (n, H, W, 3), centre (H, W, 3) and MPI (K, H, W, 5) have H
        # third from last; gt and mask (H, W) second from last
        out.append((idx, -2 if idx in (5, 7) else -3))
    return out


class Compose:
    def __init__(self, transforms):
        self.transforms = list(transforms)

    def __call__(self, data):
        for t in self.transforms:
            data = t(data)
        return data


def _zoom_index(length: int, factor: float):
    """Source index of each output sample of a nearest-neighbour zoom along
    one axis, by the rule of ``scipy.ndimage.zoom(order=0)``: output length
    ``round(length * factor)``, corners aligned, source coordinate ``c = k *
    (L-1)/(N-1)`` in float64, index ``floor(c + 0.5)``; a coordinate that
    rounding puts past ``L - 1`` falls outside the input and takes the
    constant 0 (scipy's default ``mode='constant'``).  Returns ``(index,
    outside)``."""
    n = int(round(length * factor))
    step = (length - 1) / (n - 1) if n > 1 else 1.0
    coord = np.arange(n, dtype=np.float64) * step
    outside = coord > length - 1
    index = np.floor(coord + 0.5).astype(np.int64)
    return np.minimum(index, length - 1), outside


def nearest_zoom(arr: np.ndarray, factor: float, h_ax: int) -> np.ndarray:
    """Rescale the ``(h_ax, h_ax + 1)`` axes of ``arr`` by ``factor``,
    nearest neighbour (``scipy.ndimage.zoom(order=0)`` of those axes)."""
    for ax in (h_ax, h_ax + 1):
        index, outside = _zoom_index(arr.shape[ax], factor)
        arr = np.take(arr, index, axis=ax)
        if outside.any():
            sl = [slice(None)] * arr.ndim
            sl[ax] = outside
            arr[tuple(sl)] = 0
    return arr


class Zoom:
    """Nearest-neighbour rescale by a factor; disparities scale with it."""

    def __init__(self, factor: float):
        self.factor = float(factor)

    def __call__(self, data):
        data = list(data)
        for idx, h_ax in _spatial_fields(data):
            data[idx] = nearest_zoom(data[idx], self.factor, h_ax)
        data[5] = data[5] * np.float32(self.factor)
        data[6] = data[6].copy()
        data[6][..., 4] *= np.float32(self.factor)
        return tuple(data)


class RandomZoom:
    def __init__(self, min_scale: float = 0.5, max_scale: float = 1.0):
        self.interval = (min_scale, max_scale)

    def __call__(self, data):
        return Zoom(random.uniform(*self.interval))(data)


class DownSampling:
    """Strided subsampling by an integer factor; disparities divide by
    it."""

    def __init__(self, factor: int):
        self.factor = int(factor)

    def __call__(self, data):
        f = self.factor
        data = list(data)
        for idx, h_ax in _spatial_fields(data):
            sl = [slice(None)] * data[idx].ndim
            sl[h_ax] = slice(None, None, f)
            sl[h_ax + 1] = slice(None, None, f)
            data[idx] = data[idx][tuple(sl)]
        data[5] = data[5] / np.float32(f)
        data[6] = data[6].copy()
        data[6][..., 4] /= np.float32(f)
        return tuple(data)


class RandomDownSampling:
    def __init__(self, max_factor: int = 4):
        self.max_factor = int(max_factor)

    def __call__(self, data):
        return DownSampling(random.randint(1, self.max_factor))(data)


class Crop:
    def __init__(self, size, pos):
        self.size = (size, size) if isinstance(size, int) else tuple(size)
        self.pos = tuple(pos)

    def __call__(self, data):
        h, w = self.size
        y, x = self.pos
        data = list(data)
        for idx, h_ax in _spatial_fields(data):
            sl = [slice(None)] * data[idx].ndim
            sl[h_ax] = slice(y, y + h)
            sl[h_ax + 1] = slice(x, x + w)
            data[idx] = data[idx][tuple(sl)]
        return tuple(data)


class CenterCrop:
    def __init__(self, size):
        self.size = (size, size) if isinstance(size, int) else tuple(size)

    def __call__(self, data):
        hh, ww = data[0].shape[-3], data[0].shape[-2]
        y = (hh - self.size[0]) // 2
        x = (ww - self.size[1]) // 2
        if y < 0 or x < 0:
            raise ValueError(f'CenterCrop {self.size} of a {hh}x{ww} '
                             f'sample')
        return Crop(self.size, (y, x))(data)


class RandomCrop:
    def __init__(self, size, pad: int = 0):
        self.size = (size, size) if isinstance(size, int) else tuple(size)
        self.pad = int(pad)

    def __call__(self, data):
        hh, ww = data[0].shape[-3], data[0].shape[-2]
        if not (hh > self.size[0] and ww > self.size[1]):
            raise ValueError(f'RandomCrop {self.size} of a {hh}x{ww} '
                             f'sample')
        y = random.randint(self.pad, hh - self.size[0] - self.pad)
        x = random.randint(self.pad, ww - self.size[1] - self.pad)
        return Crop(self.size, (y, x))(data)


def apply_color_matrix(arr: np.ndarray, mat: np.ndarray) -> np.ndarray:
    """new_channel_d = sum_c mat[d, c] * old_channel_c (channel-last)."""
    return np.einsum('...c,dc->...d', arr, mat).astype(arr.dtype)


class RedistColor:
    def __call__(self, data):
        mat = random_color_matrix()
        data = list(data)
        for i in range(min(COLOR_FIELDS, len(data))):
            if data[i] is not None:
                data[i] = apply_color_matrix(data[i], mat)
        return tuple(data)


class Contrast:
    def __init__(self, level: float = 0.9):
        self.level = float(level)

    def __call__(self, data):
        alpha = random.uniform(-self.level, self.level) + 1.0
        mean = data[0].mean()
        data = list(data)
        for i in range(min(COLOR_FIELDS, len(data))):
            if data[i] is not None:
                data[i] = (data[i] * alpha + mean * (1.0 - alpha)).astype(
                    np.float32)
        return tuple(data)


class Brightness:
    def __init__(self, level: float = 0.9):
        self.level = float(level)

    def __call__(self, data):
        alpha = random.uniform(-self.level, self.level) + 1.0
        data = list(data)
        for i in range(min(COLOR_FIELDS, len(data))):
            if data[i] is not None:
                data[i] = (data[i] * alpha).astype(np.float32)
        return tuple(data)


class Noise:
    def __init__(self, stdev: float = 0.01):
        self.stdev = float(stdev)

    def __call__(self, data):
        data = list(data)
        for i in range(min(COLOR_FIELDS, len(data))):
            if data[i] is not None:
                noise = np.random.normal(scale=self.stdev,
                                         size=data[i].shape)
                data[i] = (data[i] + noise).astype(np.float32)
        return tuple(data)


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


class IntegerShift(Shift):
    def __init__(self, disp: int):
        super().__init__(float(int(disp)))


class RandomShift:
    def __init__(self, disp_range):
        if not isinstance(disp_range, tuple):
            if not disp_range > 0:
                raise ValueError(f'RandomShift range {disp_range} must be '
                                 f'positive')
            disp_range = (-disp_range, disp_range)
        self.disp_range = disp_range

    def __call__(self, data):
        return Shift(random.uniform(*self.disp_range))(data)


def rot90_field(arr: np.ndarray, h_ax: int) -> np.ndarray:
    """90° rotation of one field: swap H and W, then flip the new H axis."""
    w_ax = h_ax + 1
    axes = list(range(arr.ndim))
    axes[h_ax], axes[w_ax] = axes[w_ax], axes[h_ax]
    return np.flip(np.transpose(arr, axes), h_ax).copy()


class Rotate90:
    """Rotate the light field by 90°, swapping the stacks accordingly.

    Stacks, centre, gt and MPI rotate; the mask does NOT (reference quirk).
    After the rotation: new_h = old_v, new_v = flip(old_h, views),
    new_i = old_d, new_d = flip(old_i, views).
    """

    def __call__(self, data):
        data = list(data)
        for idx, h_ax in _spatial_fields(data):
            if idx >= GEOM_FIELDS:
                continue
            data[idx] = rot90_field(data[idx], h_ax)

        data[0], data[1] = data[1], np.flip(data[0], -4).copy()
        if data[2] is not None and data[3] is not None:
            data[2], data[3] = data[3], np.flip(data[2], -4).copy()
        return tuple(data)


class RandomRotate:
    def __init__(self):
        self.rot = Rotate90()

    def __call__(self, data):
        for _ in range(random.randint(0, 3)):
            data = self.rot(data)
        return data


def random_color_matrix(rng=None) -> np.ndarray:
    """The reference's random row/column-stochastic 3×3 colour mix, drawn
    in the order of ``mmlf_tpu.data.transforms`` from ``rng`` (an
    ``np.random.Generator``: the training pipelines pass their seeded one)
    or, without one, from the stdlib ``random`` (``RedistColor``)."""
    def u(a, b):
        return random.uniform(a, b) if rng is None else \
            float(rng.uniform(a, b))

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
