"""Training input pipeline: a device-resident scene pyramid, index-only
batches from the host, window gather (kernel K1) and augmentation on the
device.

The counterpart of ``mmlf_tpu.data.pipeline``'s device path:

HOST (numpy): per sample, the scene, the downsample factor ``f`` and the
window position (snapped to an 8/16 grid, the snap absorbed by the crop
offset), plus every augmentation parameter (sub-pixel shift, rotation k,
colour matrix, brightness, contrast).  ``DevicePipeline.sample_batch``
draws them from one ``np.random.Generator`` in the JAX package's order, so
the same seed gives the identical ``DeviceBatch``.

DEVICE: ``gather_augment`` cuts the windows out of the packed pyramid
(``build_device_cache``) with kernel K1 (``ops/kernels/window_gather.py``)
and runs the augmentation chain on them (``data/augment2.py``):

  ``Shift(train_shift) → RandomDownSampling → RandomShift(1) →
  RandomCrop(ps+16) → CenterCrop(ps) → RandomRotate → RedistColor →
  Brightness → Contrast``

with the static shift applied once when the scenes are cached, and the
random sub-pixel shift wrapping circularly within the window (the JAX
package's documented deviation from the reference; the wrap lands in the
guard band that the crop discards).

``gather_windows`` + ``augment_batch`` are the plain per-sample version of
the same chain, kept as its oracle.

The host pipeline (``--host_pipeline``, and the JAX package's automatic
switch for a scene cache of 8 GiB or more, or scenes of different shapes):
``TrainPipeline.sample_batch`` draws every random number first, in the JAX
package's order, then cuts the stride-f windows on the host in a thread
pool (``native.strided_window`` releases the GIL; ``--train_num_workers
0`` cuts them in the calling thread) and returns a ``Batch`` of numpy
arrays equal to ``mmlf_tpu.data.pipeline.TrainPipeline.sample_batch``'s for
a seed.  ``batch_to_device`` copies it to the card (from pinned host
memory) and ``augment_host_batch`` augments a whole microbatch at once
with the gathers of ``data/augment2.py``: the stacks are packed into the
window layout kernel K1 emits (stack × view × colour on the last axis), so
the host path and the device path share one augmentation.
"""

from __future__ import annotations

import weakref
from concurrent.futures import ThreadPoolExecutor
from dataclasses import dataclass
from typing import NamedTuple

import numpy as np
import torch

from ..config import Config
from ..native import strided_window
from ..ops.kernels.window_gather import AUX_CH, MPI_CH, window_gather
from ..ops.shift import shift_lf
from ..trace import span
from . import transforms as T
from .hci4d import HCI4D, pad_mpi

GUARD = 8          # wrap guard for the ±1 px random shift at the outer views
EXTRA = 16         # RandomCrop(ps+16) → CenterCrop(ps) band
MAX_PLANES = 12
SNAP_PAD = 4       # window starts this far before the RandomCrop position…
MIN_WRAP_GUARD = 5  # …and the crop keeps ≥ this many guard pixels each side


class AugParams(NamedTuple):
    """Per-sample augmentation parameters (host-sampled numpy arrays)."""
    shift: np.ndarray        # (b,) float32 random sub-pixel shift disparity
    y_off: np.ndarray        # (b,) int32 crop offset within the window,
    x_off: np.ndarray        # (b,) int32 [0, win - ps - EXTRA//2 - guard]
    rot_k: np.ndarray        # (b,) int32 number of 90° rotations, [0, 3]
    color: np.ndarray        # (b, 3, 3) float32 colour redistribution
    brightness: np.ndarray   # (b,) float32
    contrast: np.ndarray     # (b,) float32


class DeviceBatch(NamedTuple):
    """Per-sample window coordinates + augmentation parameters (host)."""
    scene: np.ndarray        # (b,) int32 scene index
    factor: np.ndarray       # (b,) int32 downsample factor (1-based)
    ws_y: np.ndarray         # (b,) int32 window start (level coords, 8-snap)
    ws_x: np.ndarray         # (b,) int32 window start (level coords, 16-snap)
    aug: AugParams


class Batch(NamedTuple):
    """Window stacks in the plain path's layout: numpy arrays from the host
    pipeline's ``sample_batch``, tensors once on the device."""
    h: torch.Tensor          # (b, n, win, win, 3)
    v: torch.Tensor
    i: torch.Tensor
    d: torch.Tensor
    gt: torch.Tensor         # (b, win, win)
    mpi: torch.Tensor        # (b, K, win, win, 5)
    mask: torch.Tensor       # (b, win, win) int32
    aug: AugParams


def window_size(ps: int) -> int:
    """Window side = patch + crop band + wrap guards, rounded up to 16 (the
    packed cache's tile grid in the JAX package; kept so both packages cut
    the same windows)."""
    return (ps + EXTRA + 2 * GUARD + 15) // 16 * 16


def chunk_slice(batch, start: int, stop: int):
    """Samples ``[start, stop)`` of a ``DeviceBatch`` or a ``Batch`` (one
    accumulation chunk: contiguous, as the JAX step reshapes the batch); a
    field left out (None) stays None."""
    sl = slice(start, stop)
    aug = AugParams(*(a[sl] for a in batch.aug))
    return type(batch)(*(None if f is None else f[sl] for f in batch[:-1]),
                       aug)


class TrainPipeline:
    """The cached (static-shifted) scenes, the window-position sampler and
    the host batches of ``--host_pipeline``."""

    def __init__(self, dataset: HCI4D, cfg: Config, seed: int = 0):
        self.cfg = cfg
        self.ps = cfg.train_ps
        self.win = window_size(self.ps)
        self.augment = not cfg.train_no_data_augment
        self.max_f = cfg.train_max_downscale if self.augment else 1
        self.rng = np.random.default_rng(seed)
        self._pool = None            # the window cutters, started lazily

        if not dataset.cache:
            dataset.cache_scenes()

        self.scenes = []
        for data in dataset.data:
            with span('mmlf.pipeline.shift'):
                h, v, i, d, center, gt, mpi, mask, _ = data
                if cfg.train_shift != 0.0:
                    # the static Shift is deterministic and first in the
                    # chain: applied once here
                    h, v, i, d = T.np_shift_lf(h, v, i, d, cfg.train_shift)
                    gt = gt - np.float32(cfg.train_shift)
                    mpi = mpi.copy()
                    mpi[..., 4] -= np.float32(cfg.train_shift)
                self.scenes.append(dict(
                    h=h, v=v, i=i, d=d, gt=gt.astype(np.float32),
                    mpi=pad_mpi(mpi.astype(np.float32), MAX_PLANES),
                    mask=mask.astype(np.int32)))

        # clamp the downsample range to factors whose level still fits one
        # window
        min_dim = min(min(s['gt'].shape) for s in self.scenes)
        fit = self.max_f
        while fit > 1 and (min_dim + fit - 1) // fit < self.win:
            fit -= 1
        if fit < self.max_f:
            print(f'train_max_downscale clamped {self.max_f} -> {fit}: '
                  f'window {self.win} does not fit a {min_dim}px scene '
                  f'at coarser levels')
            self.max_f = fit

    def _positions(self, shape, f: int):
        """Window start (level coords, rows snapped to 8 and columns to 16)
        and the RandomCrop offset within the window, as
        ``(ws_y, ws_x, y_off, x_off)``.  The offset is clamped so the
        sub-pixel shift's wrap keeps >= MIN_WRAP_GUARD guard pixels on each
        side of the crop."""
        win = self.win
        hf = (shape[0] + f - 1) // f
        wf = (shape[1] + f - 1) // f
        if hf < win or wf < win:
            raise ValueError(f'scene too small ({hf}x{wf}) for ps={self.ps} '
                             f'window {win} at downscale {f}; lower '
                             f'train_ps or train_max_downscale')
        # RandomCrop(ps+16) position in the downsampled grid (inclusive
        # upper bound, like the reference's random.randint)
        y112 = self.rng.integers(0, hf - (self.ps + EXTRA) + 1)
        x112 = self.rng.integers(0, wf - (self.ps + EXTRA) + 1)
        ws_y = int(np.clip(y112 - SNAP_PAD, 0, max(hf - win, 0))) // 8 * 8
        ws_x = int(np.clip(x112 - SNAP_PAD, 0, max(wf - win, 0))) // 16 * 16
        max_off = win - self.ps - EXTRA // 2 - MIN_WRAP_GUARD
        return (ws_y, ws_x, min(int(y112 - ws_y), max_off),
                min(int(x112 - ws_x), max_off))

    def _aug_params(self, y_offs, x_offs, draw_rot) -> AugParams:
        """The augmentation parameters of a batch with these crop offsets,
        drawn from ``self.rng`` in the JAX package's order (``draw_rot(n)``
        draws the rotations in its place); the identity without
        augmentation."""
        b = len(y_offs)
        if not self.augment:
            return AugParams(
                shift=np.zeros(b, np.float32), y_off=y_offs, x_off=x_offs,
                rot_k=np.zeros(b, np.int32),
                color=np.broadcast_to(np.eye(3, dtype=np.float32),
                                      (b, 3, 3)).copy(),
                brightness=np.ones(b, np.float32),
                contrast=np.ones(b, np.float32))
        return AugParams(
            shift=self.rng.uniform(-1.0, 1.0, b).astype(np.float32),
            y_off=y_offs, x_off=x_offs, rot_k=draw_rot(b),
            color=np.stack([T.random_color_matrix(self.rng)
                            for _ in range(b)]),
            brightness=(self.rng.uniform(-0.9, 0.9, b)
                        + 1.0).astype(np.float32),
            contrast=(self.rng.uniform(-0.9, 0.9, b)
                      + 1.0).astype(np.float32))

    def _cut_window(self, scene: dict, f: int, ws_y: int, ws_x: int) -> dict:
        """One stride-f window of every field at a given start (no random
        draw, so any thread may cut it).  GT and MPI disparities come back
        divided by ``f``."""
        win = self.win

        def cut(arr, spatial_from):
            if spatial_from == 1 and arr.dtype == np.float32 and \
                    arr.flags.c_contiguous:
                out = strided_window(arr, ws_y, ws_x, f, win)
                if out is not None:
                    return out
            sl = (slice(None),) * spatial_from + (
                slice(None, None, f),) * 2
            sl2 = (slice(None),) * spatial_from + (
                slice(ws_y, ws_y + win), slice(ws_x, ws_x + win))
            return np.ascontiguousarray(arr[sl][sl2])

        gt = scene['gt'][::f, ::f]
        mpi = cut(scene['mpi'], 1).copy()
        mpi[..., 4] /= np.float32(f)
        return {'h': cut(scene['h'], 1), 'v': cut(scene['v'], 1),
                'i': cut(scene['i'], 1), 'd': cut(scene['d'], 1),
                'gt': np.ascontiguousarray(
                    gt[ws_y:ws_y + win, ws_x:ws_x + win]) / np.float32(f),
                'mask': cut(scene['mask'], 0), 'mpi': mpi}

    def close(self) -> None:
        """Stop the window-cutter threads (a finalizer also does, when the
        pipeline is collected)."""
        if self._pool is not None:
            self._pool.shutdown(wait=False)
            self._pool = None

    def sample_batch(self, batch_size: int, pin_memory: bool = False) -> Batch:
        """A host batch of ``batch_size`` windows and their augmentation
        parameters, equal field for field to the JAX package's
        ``TrainPipeline.sample_batch`` for the same generator state.

        Every random number is drawn first, in the JAX package's order; the
        windows are then cut by ``train_num_workers`` threads (0: in this
        thread).  ``pin_memory`` stacks the fields into page-locked host
        memory, for a fast copy to the card."""
        draws = []
        for _ in range(batch_size):
            idx = int(self.rng.integers(0, len(self.scenes)))
            f = int(self.rng.integers(1, self.max_f + 1))
            draws.append((idx, f) + self._positions(
                self.scenes[idx]['gt'].shape, f))

        def cut(draw):
            idx, f, ws_y, ws_x, _, _ = draw
            return self._cut_window(self.scenes[idx], f, ws_y, ws_x)

        nw = int(self.cfg.train_num_workers)
        if batch_size > 1 and nw > 0:
            if self._pool is None:
                self._pool = ThreadPoolExecutor(max_workers=nw)
                weakref.finalize(self, self._pool.shutdown, wait=False)
            windows = list(self._pool.map(cut, draws))
        else:
            windows = [cut(d) for d in draws]

        aug = self._aug_params(
            np.asarray([d[4] for d in draws], np.int32),
            np.asarray([d[5] for d in draws], np.int32),
            lambda n: self.rng.integers(0, 4, n).astype(np.int32))

        def stack(key):
            parts = [w[key] for w in windows]
            if not pin_memory:
                return np.stack(parts)
            out = torch.empty((batch_size,) + parts[0].shape,
                              dtype=torch.from_numpy(parts[0]).dtype,
                              pin_memory=True).numpy()
            return np.stack(parts, out=out)

        return Batch(h=stack('h'), v=stack('v'), i=stack('i'), d=stack('d'),
                     gt=stack('gt'), mpi=stack('mpi'), mask=stack('mask'),
                     aug=aug)


@dataclass
class PackedCache:
    """The packed scene pyramid in device memory, one entry per downsample
    factor f = 1..max_f; each level holds every (static-shifted) scene at
    stride f with gt and MPI disparities divided by f:

      * ``img[f-1]``: ``(S, Hf, Wf, CI)`` — the four view stacks folded
        into the channels, order stack(4) × view(n) × rgb(3), zero-padded
        to a multiple of 128 (CI = 128 for 9 views);
      * ``aux[f-1]``: ``(S, Hf, Wf*8)`` — per pixel [gt, mask, 0, …];
      * ``mpi[f-1]``: ``(S, Hf, Wf*64)`` — plane-major K*5 = 60 used.
    """
    img: tuple
    aux: tuple
    mpi: tuple
    views: int = 9


def _round_up(x: int, m: int) -> int:
    return (x + m - 1) // m * m


def build_device_cache(scenes, max_f: int = 4, device='cuda',
                       img_dtype=torch.float32) -> PackedCache:
    """Pack ``TrainPipeline`` scene dicts into the pyramid layout (host
    numpy, once) and move the levels to ``device``.  The image levels take
    ``img_dtype`` (bfloat16 under ``--cache_bf16``, rounded to nearest as
    the JAX package's cast rounds); aux and mpi stay float32."""
    dev = torch.device(device)
    n = scenes[0]['h'].shape[0]
    ci = _round_up(4 * n * 3, 128)

    img_levels, aux_levels, mpi_levels = [], [], []
    for f in range(1, max_f + 1):
        imgs, auxs, mpis = [], [], []
        for s in scenes:
            # (n, Hf, Wf, 3) per stack → (Hf, Wf, n*3), stack-major concat
            planes = []
            for k in ('h', 'v', 'i', 'd'):
                a = np.moveaxis(s[k][:, ::f, ::f], 0, 2)   # (Hf, Wf, n, 3)
                planes.append(a.reshape(a.shape[0], a.shape[1], n * 3))
            hf, wf = planes[0].shape[:2]
            img = np.zeros((hf, wf, ci), np.float32)
            img[..., :4 * n * 3] = np.concatenate(planes, -1)
            imgs.append(img)

            aux = np.zeros((hf, wf, AUX_CH), np.float32)
            aux[..., 0] = s['gt'][::f, ::f] / np.float32(f)
            aux[..., 1] = s['mask'][::f, ::f]
            auxs.append(aux.reshape(hf, wf * AUX_CH))

            m = np.moveaxis(s['mpi'][:, ::f, ::f], 0, 2)   # (Hf, Wf, K, 5)
            m = m.copy()
            m[..., 4] /= np.float32(f)
            k5 = m.shape[2] * 5
            mp = np.zeros((hf, wf, MPI_CH), np.float32)
            mp[..., :k5] = m.reshape(hf, wf, k5)
            mpis.append(mp.reshape(hf, wf * MPI_CH))

        img_levels.append(torch.from_numpy(np.stack(imgs)).to(
            dev, img_dtype))
        aux_levels.append(torch.from_numpy(np.stack(auxs)).to(dev))
        mpi_levels.append(torch.from_numpy(np.stack(mpis)).to(dev))

    return PackedCache(img=tuple(img_levels), aux=tuple(aux_levels),
                       mpi=tuple(mpi_levels), views=n)


def _gather(cache: PackedCache, batch: DeviceBatch, win: int,
            with_mpi: bool):
    return window_gather(cache.img, cache.aux, cache.mpi, batch.scene,
                         np.asarray(batch.factor) - 1, batch.ws_y,
                         batch.ws_x, win, with_mpi=with_mpi)


def gather_windows(cache: PackedCache, batch: DeviceBatch,
                   win: int) -> Batch:
    """Cut the per-sample windows (kernel K1) and unpack them into the
    per-view stack layout of the plain path.  GT and MPI disparities come
    back divided by the sample's factor."""
    img, aux, mpi = _gather(cache, batch, win, with_mpi=True)
    b = img.shape[0]
    n3 = cache.views * 3

    def stack_of(k):
        s = img[..., k * n3:(k + 1) * n3]
        s = s.reshape(b, win, win, cache.views, 3)
        return s.permute(0, 3, 1, 2, 4)

    aux = aux.reshape(b, win, win, AUX_CH)
    mpi = mpi.reshape(b, win, win, MPI_CH)[..., :MAX_PLANES * 5]
    mpi = mpi.reshape(b, win, win, MAX_PLANES, 5).permute(0, 3, 1, 2, 4)
    return Batch(h=stack_of(0), v=stack_of(1), i=stack_of(2), d=stack_of(3),
                 gt=aux[..., 0], mpi=mpi, mask=aux[..., 1].to(torch.int32),
                 aug=batch.aug)


def gather_augment(cache: PackedCache, batch: DeviceBatch, ps: int,
                   win: int, with_mpi: bool = True):
    """The train step's input path: kernel K1 window gather, then the
    batched augmentation of ``data/augment2.py``, straight to model-ready
    tensors.  Equal to ``augment_batch(gather_windows(...))`` up to float
    rounding (``tests/test_torch_pipeline.py``).

    :returns: ``(h, v, i, d, gt, mpi, mask)``: the four stacks folded to
        the model's NCHW layout ``(B, n*3, ps, ps)`` (pass ``folded=True``
        to FeedForward), gt ``(B, ps, ps)``, MPI ``(B, K, ps, ps, 5)`` (None
        when ``with_mpi`` is False: no loss of the run reads it) and mask
        ``(B, ps, ps)`` int32.
    """
    from .augment2 import aug_tensors, augment_packed, augment_targets

    img, aux, mpi = _gather(cache, batch, win, with_mpi)
    aug = aug_tensors(batch.aug, img.device)
    h, v, i, d = augment_packed(img, aug, ps, cache.views)
    gt, mpi, mask = augment_targets(aux, mpi, aug, ps, MAX_PLANES)
    return h, v, i, d, gt, mpi, mask


def _rot90_sample(h, v, i, d, gt, mpi):
    """One 90° rotation of a single sample (stacks (n,P,P,3), gt (P,P),
    mpi (K,P,P,5)); the mask is deliberately NOT rotated (reference
    quirk)."""
    def rot_s(a):
        return torch.flip(torch.swapaxes(a, -3, -2), (-3,))

    def rot_g(a):
        return torch.flip(torch.swapaxes(a, -2, -1), (-2,))

    h, v, i, d = rot_s(h), rot_s(v), rot_s(i), rot_s(d)
    h, v = v, torch.flip(h, (-4,))
    i, d = d, torch.flip(i, (-4,))
    return h, v, i, d, rot_g(gt), rot_s(mpi)


def augment_sample(h, v, i, d, gt, mpi, mask, aug: AugParams, b: int,
                   ps: int):
    """The augmentation chain on one window sample ``b`` (plain version)."""
    shift = float(aug.shift[b])
    h, v, i, d = shift_lf(h, v, i, d, aug.shift[b])
    gt = gt - shift
    mpi = mpi.clone()
    mpi[..., 4] -= shift

    # RandomCrop completion + CenterCrop: the patch starts at
    # (y_off + EXTRA/2) within the window
    y0 = int(aug.y_off[b]) + EXTRA // 2
    x0 = int(aug.x_off[b]) + EXTRA // 2

    def crop_s(a):
        return a[:, y0:y0 + ps, x0:x0 + ps]

    h, v, i, d, mpi = crop_s(h), crop_s(v), crop_s(i), crop_s(d), crop_s(mpi)
    gt = gt[y0:y0 + ps, x0:x0 + ps]
    mask = mask[y0:y0 + ps, x0:x0 + ps]

    for _ in range(int(aug.rot_k[b])):
        h, v, i, d, gt, mpi = _rot90_sample(h, v, i, d, gt, mpi)

    color = torch.as_tensor(aug.color[b], device=h.device)
    h, v, i, d = (torch.einsum('...c,dc->...d', a, color)
                  for a in (h, v, i, d))
    bright = float(aug.brightness[b])
    h, v, i, d = (a * bright for a in (h, v, i, d))
    contrast = float(aug.contrast[b])
    pivot = torch.mean(h) * (1.0 - contrast)
    h, v, i, d = (a * contrast + pivot for a in (h, v, i, d))
    return h, v, i, d, gt, mpi, mask


def augment_batch(batch: Batch, ps: int):
    """``augment_sample`` over the batch: the plain oracle of
    ``gather_augment``.  Stacks come back unfolded ``(b, n, ps, ps, 3)``."""
    out = [augment_sample(batch.h[b], batch.v[b], batch.i[b], batch.d[b],
                          batch.gt[b], batch.mpi[b], batch.mask[b],
                          batch.aug, b, ps)
           for b in range(batch.h.shape[0])]
    return tuple(torch.stack(field) for field in zip(*out))


def batch_to_device(batch: Batch, device, with_mpi: bool = True) -> Batch:
    """A host ``Batch`` on ``device``: the window fields as tensors (MPI
    only ``with_mpi``, else None), the augmentation parameters left on the
    host.  Copies from page-locked memory when the batch was sampled with
    ``pin_memory``; the copy completes before this returns."""
    def put(a):
        return torch.from_numpy(a).to(device)

    return Batch(h=put(batch.h), v=put(batch.v), i=put(batch.i),
                 d=put(batch.d), gt=put(batch.gt),
                 mpi=put(batch.mpi) if with_mpi else None,
                 mask=put(batch.mask), aug=batch.aug)


def augment_host_batch(batch: Batch, ps: int):
    """The augmentation chain of ``augment_batch`` on a whole microbatch of
    host-cut windows at once (a ``Batch`` of tensors, MPI optional): the
    stacks are packed into K1's window layout ``(B, win, win, 4·n·3)``
    (stack × view × colour) and augmented by ``augment2.augment_packed``,
    gt and mask by ``augment_targets``.  Equal to ``augment_batch`` up to
    float rounding (the i and d stacks shift rows first, then columns;
    ``augment_sample`` the other way round).

    :returns: ``(h, v, i, d, gt, mpi, mask)`` with the stacks in the
        model's folded NCHW layout ``(B, n*3, ps, ps)`` (``folded=True``),
        MPI ``(B, K, ps, ps, 5)`` or None.
    """
    from .augment2 import aug_tensors, augment_packed, augment_targets

    b, n, win = batch.h.shape[:3]
    img = torch.stack([batch.h, batch.v, batch.i, batch.d], 1)
    img = img.permute(0, 3, 4, 1, 2, 5).reshape(b, win, win, 4 * n * 3)
    aux = torch.stack([batch.gt, batch.mask.to(batch.gt.dtype)], -1)
    mpi = batch.mpi
    planes = 0 if mpi is None else mpi.shape[1]
    if mpi is not None:
        mpi = mpi.permute(0, 2, 3, 1, 4).reshape(b, win, win * planes * 5)
    aug = aug_tensors(batch.aug, img.device)
    h, v, i, d = augment_packed(img, aug, ps, n)
    gt, mpi, mask = augment_targets(aux.reshape(b, win, win * 2), mpi, aug,
                                    ps, planes)
    return h, v, i, d, gt, mpi, mask


class DevicePipeline(TrainPipeline):
    """Index-only batches for a device cache of the scenes."""

    def __init__(self, dataset: HCI4D, cfg: Config, seed: int = 0,
                 device='cuda'):
        super().__init__(dataset, cfg, seed)
        shapes = {s['gt'].shape for s in self.scenes}
        if len(shapes) != 1:
            raise ValueError(f'the device cache needs one scene shape, got '
                             f'{sorted(shapes)}')
        self.scene_shape = shapes.pop()
        img_dtype = torch.bfloat16 if cfg.cache_bf16 else torch.float32
        with span('mmlf.pipeline.pack'):
            self.cache = build_device_cache(self.scenes, self.max_f, device,
                                            img_dtype)

    def _stratified_rot(self, batch_size: int) -> np.ndarray:
        """Rotations drawn as the JAX package draws them: within each
        gradient-accumulation chunk the first half takes an even k (0/2)
        and the second half an odd k (1/3); the per-sample marginal stays
        uniform over {0, 1, 2, 3}."""
        accum = max(1, int(self.cfg.train_accum or 1))
        chunk = batch_size // accum if accum > 1 and \
            batch_size % accum == 0 else batch_size
        out = np.empty(batch_size, np.int32)
        for c0 in range(0, batch_size, chunk):
            n = min(chunk, batch_size - c0)
            h = n // 2
            out[c0:c0 + h] = self.rng.integers(0, 2, h) * 2
            out[c0 + h:c0 + n] = self.rng.integers(0, 2, n - h) * 2 + 1
        return out

    def sample_batch(self, batch_size: int) -> DeviceBatch:
        scene_idx = self.rng.integers(0, len(self.scenes), batch_size)
        factors = self.rng.integers(1, self.max_f + 1, batch_size)
        ws_y = np.zeros(batch_size, np.int32)
        ws_x = np.zeros(batch_size, np.int32)
        y_offs = np.zeros(batch_size, np.int32)
        x_offs = np.zeros(batch_size, np.int32)
        for b in range(batch_size):
            ws_y[b], ws_x[b], y_offs[b], x_offs[b] = self._positions(
                self.scene_shape, int(factors[b]))

        aug = self._aug_params(y_offs, x_offs, self._stratified_rot)
        return DeviceBatch(scene=scene_idx.astype(np.int32),
                           factor=factors.astype(np.int32),
                           ws_y=ws_y, ws_x=ws_x, aug=aug)
