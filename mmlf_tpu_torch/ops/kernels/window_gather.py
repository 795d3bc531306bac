"""Training-window gather from the packed scene pyramid (kernel K1).

Replaces the Pallas TPU kernel ``mmlf_tpu/ops/pallas/window_gather.py``
(``pallas_window_gather``, body ``_gather_kernel``).  For every sample b
it copies one ``win × win`` window of scene ``scene[b]`` at pyramid level
``level[b]``, starting at ``(ws_y[b], ws_x[b])``, from the three packed
fields of ``data/pipeline.PackedCache``:

  img ``(S, Hf, Wf, CI)``  → ``(B, win, win, CI)``
  aux ``(S, Hf, Wf*8)``    → ``(B, win, win*8)``   (gt, mask, 6 spare)
  mpi ``(S, Hf, Wf*64)``   → ``(B, win, win*64)``  (12 planes × 5, padded)

A pure copy of the selected level only; ``with_mpi=False`` skips the MPI
field and returns ``None`` for it.  Layout and padding are the TPU
kernel's, so the outputs compare bit for bit.  The image field is float32,
or bfloat16 under ``--cache_bf16`` (the window comes back in its dtype, as
the TPU kernel returns it); aux and mpi are float32.

On CUDA tensors the wrapper launches the hand-written kernel
``csrc/window_gather.cu`` (its note gives the bound on an H100: bytes); on
CPU tensors it takes the plain PyTorch version beside it.  There is no
fallback: a build or launch error raises.  The index vectors are host
values (numpy or CPU tensors, as the host sampler draws them); the wrapper
checks them against the level shapes before anything runs.
``window_gather.launches`` counts kernel launches with a float32 image
field, ``window_gather.launches_bf16`` those with a bfloat16 one.

``window_copy`` is the same copy for one field and one level, the
counterpart of the probe scripts' Pallas kernels (``pallas_gather`` of
``scripts/gather_probe3.py`` and ``gather_probe4.py``, and
``pallas_gather2``, the schedule that loads window b + 1 while window b is
stored, as ``ring=True``); it counts ``.launches`` and ``.launches_ring``.
"""

from __future__ import annotations

import ctypes

import numpy as np
import torch

from . import build

AUX_CH = 8      # gt, mask, 6 spare
MPI_CH = 64     # MAX_PLANES(12) * 5 = 60 used


def plain_window_gather(img_levels, aux_levels, mpi_levels, index: np.ndarray,
                        win: int, with_mpi: bool = True):
    """Plain PyTorch version: per sample, slice the window of its level.
    ``index`` is the validated ``(4, B)`` host array (scene, level, wy,
    wx)."""
    def cut(levels, ch):
        out = []
        for s, lev, wy, wx in index.T.tolist():
            out.append(levels[lev][s, wy:wy + win, wx * ch:(wx + win) * ch])
        return torch.stack(out)

    img = torch.stack([img_levels[lev][s, wy:wy + win, wx:wx + win]
                       for s, lev, wy, wx in index.T.tolist()])
    aux = cut(aux_levels, AUX_CH)
    mpi = cut(mpi_levels, MPI_CH) if with_mpi else None
    return img, aux, mpi


def _check(img_levels, aux_levels, mpi_levels, scene, level, ws_y, ws_x,
           win: int, with_mpi: bool) -> np.ndarray:
    """Validate shapes, dtypes, devices and indices; returns the ``(4, B)``
    int32 host index array."""
    n_lev = len(img_levels)
    if n_lev < 1 or len(aux_levels) != n_lev or \
            (with_mpi and (mpi_levels is None or len(mpi_levels) != n_lev)):
        raise ValueError('img/aux/mpi need the same number (>= 1) of levels')
    dev = img_levels[0].device
    n_scenes, ci = img_levels[0].shape[0], img_levels[0].shape[-1]
    if img_levels[0].dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f'img must be float32 or bfloat16, got '
                        f'{img_levels[0].dtype}')
    fields = [('img', img_levels, ci), ('aux', aux_levels, AUX_CH)]
    if with_mpi:
        fields.append(('mpi', mpi_levels, MPI_CH))
    for name, levels, ch in fields:
        for lev, t in enumerate(levels):
            hf, wf = img_levels[lev].shape[1:3]
            want = (n_scenes, hf, wf, ci) if name == 'img' else \
                (n_scenes, hf, wf * ch)
            if tuple(t.shape) != want:
                raise ValueError(f'{name} level {lev} has shape '
                                 f'{tuple(t.shape)}, expected {want}')
            want_dtype = img_levels[0].dtype if name == 'img' else \
                torch.float32
            if t.dtype != want_dtype:
                raise TypeError(f'{name} level {lev} must be {want_dtype}, '
                                f'got {t.dtype}')
            if t.device != dev:
                raise ValueError(f'{name} level {lev} is on {t.device}, '
                                 f'img level 0 on {dev}')

    index = np.stack([np.asarray(a.cpu() if torch.is_tensor(a) else a)
                      .astype(np.int64).reshape(-1)
                      for a in (scene, level, ws_y, ws_x)])
    s, lev, wy, wx = index
    if not (len(s) == len(lev) == len(wy) == len(wx)) or len(s) < 1:
        raise ValueError('scene/level/ws_y/ws_x need one equal length >= 1')
    if s.min() < 0 or s.max() >= n_scenes:
        raise ValueError(f'scene index out of [0, {n_scenes})')
    if lev.min() < 0 or lev.max() >= n_lev:
        raise ValueError(f'level out of [0, {n_lev})')
    hf = np.array([t.shape[1] for t in img_levels])[lev]
    wf = np.array([t.shape[2] for t in img_levels])[lev]
    if wy.min() < 0 or wx.min() < 0 or np.any(wy + win > hf) or \
            np.any(wx + win > wf):
        raise ValueError(f'a {win}x{win} window leaves its level')
    return index.astype(np.int32)


def _launch(img_levels, aux_levels, mpi_levels, index, win, with_mpi,
            out_img, out_aux, out_mpi) -> None:
    lib = build.load('window_gather')
    n_lev = len(img_levels)
    if n_lev > lib.mmlf_window_gather_max_levels():
        raise ValueError(f'{n_lev} levels exceed the kernel\'s '
                         f'{lib.mmlf_window_gather_max_levels()}')
    fn = lib.mmlf_window_gather_launch
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int, ctypes.c_void_p] + \
        [ctypes.c_int] * 5 + [ctypes.c_void_p] * 3 + [ctypes.c_int,
                                                      ctypes.c_void_p]
    ptrs = ctypes.c_void_p * n_lev
    ints = ctypes.c_int * n_lev
    img_p = ptrs(*[t.data_ptr() for t in img_levels])
    aux_p = ptrs(*[t.data_ptr() for t in aux_levels])
    mpi_p = ptrs(*([t.data_ptr() for t in mpi_levels] if with_mpi
                   else [None] * n_lev))
    heights = ints(*[t.shape[1] for t in img_levels])
    widths = ints(*[t.shape[2] for t in img_levels])
    dev = img_levels[0].device
    idx = torch.from_numpy(np.ascontiguousarray(index)).to(dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    err = fn(ctypes.addressof(img_p), ctypes.addressof(aux_p),
             ctypes.addressof(mpi_p), ctypes.addressof(heights),
             ctypes.addressof(widths), n_lev, idx.data_ptr(),
             index.shape[1], win, img_levels[0].shape[-1],
             img_levels[0].element_size(), int(with_mpi),
             out_img.data_ptr(), out_aux.data_ptr(),
             out_mpi.data_ptr() if with_mpi else None, dev.index, stream)
    build.check(lib, err, 'window gather kernel launch')


def window_gather(img_levels, aux_levels, mpi_levels, scene, level, ws_y,
                  ws_x, win: int, with_mpi: bool = True):
    """Gather per-sample windows from the packed pyramid.

    :param img_levels: per level ``(S, Hf, Wf, CI)`` float32 (CI % 4 == 0)
        or bfloat16 (CI % 8 == 0)
    :param aux_levels: per level ``(S, Hf, Wf*8)`` float32
    :param mpi_levels: per level ``(S, Hf, Wf*64)`` float32 (unused and may
        be None when ``with_mpi`` is False)
    :param scene, level, ws_y, ws_x: ``(B,)`` host integers (numpy or CPU
        tensors): scene index, 0-based level, window row and column start
    :returns: ``(img, aux, mpi)``: ``(B, win, win, CI)`` in img's dtype,
        ``(B, win, win*8)``, ``(B, win, win*64)`` or None
    """
    index = _check(img_levels, aux_levels, mpi_levels, scene, level, ws_y,
                   ws_x, win, with_mpi)
    dev = img_levels[0].device
    if dev.type == 'cpu':
        return plain_window_gather(img_levels, aux_levels, mpi_levels, index,
                                   win, with_mpi)
    if dev.type != 'cuda':
        raise ValueError(f'no window gather for device {dev}')

    levels = list(img_levels) + list(aux_levels) + \
        (list(mpi_levels) if with_mpi else [])
    for t in levels:
        if not t.is_contiguous() or t.data_ptr() % 16:
            raise ValueError('the window gather kernel needs contiguous, '
                             '16-byte aligned levels')
    b, ci = index.shape[1], img_levels[0].shape[-1]
    img_dtype = img_levels[0].dtype
    if (ci * img_levels[0].element_size()) % 16:
        raise ValueError(f'the kernel copies 16-byte words: CI = {ci} of '
                         f'{img_dtype} is not a whole number of them')
    out_img = torch.empty((b, win, win, ci), dtype=img_dtype, device=dev)
    out_aux = torch.empty((b, win, win * AUX_CH), dtype=torch.float32,
                          device=dev)
    out_mpi = torch.empty((b, win, win * MPI_CH), dtype=torch.float32,
                          device=dev) if with_mpi else None
    _launch(img_levels, aux_levels, mpi_levels, index, win, with_mpi,
            out_img, out_aux, out_mpi)
    if img_dtype == torch.bfloat16:
        window_gather.launches_bf16 += 1
    else:
        window_gather.launches += 1
    return out_img, out_aux, out_mpi


window_gather.launches = 0
window_gather.launches_bf16 = 0


def plain_window_copy(cache, index: np.ndarray, win: int):
    """Plain PyTorch version of ``window_copy``: per sample, slice the
    window.  ``index`` is the validated ``(3, B)`` host array (scene, wy,
    wx)."""
    return torch.stack([cache[s, wy:wy + win, wx:wx + win]
                        for s, wy, wx in index.T.tolist()])


def window_copy(cache, scene, ws_y, ws_x, win: int, ring: bool = False):
    """``out[b] = cache[scene[b], wy[b]:wy[b]+win, wx[b]:wx[b]+win, :]``.

    :param cache: ``(S, H, W, C)`` float32 or bfloat16, C times the
        element size a multiple of 4 bytes
    :param scene, ws_y, ws_x: ``(B,)`` host integers (numpy or CPU tensors)
    :param ring: the two-slot bulk-copy ring (``pallas_gather2``'s
        schedule), which needs a pixel of a whole number of 16-byte words
    :returns: ``(B, win, win, C)`` in the cache's dtype
    """
    if cache.ndim != 4 or cache.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f'cache must be (S, H, W, C) float32 or bfloat16, '
                         f'got {tuple(cache.shape)} {cache.dtype}')
    n_scenes, height, width, c = cache.shape
    index = np.stack([np.asarray(a.cpu() if torch.is_tensor(a) else a)
                      .astype(np.int64).reshape(-1)
                      for a in (scene, ws_y, ws_x)])
    s, wy, wx = index
    if not (len(s) == len(wy) == len(wx)) or len(s) < 1:
        raise ValueError('scene/ws_y/ws_x need one equal length >= 1')
    if s.min() < 0 or s.max() >= n_scenes:
        raise ValueError(f'scene index out of [0, {n_scenes})')
    if wy.min() < 0 or wx.min() < 0 or wy.max() + win > height or \
            wx.max() + win > width:
        raise ValueError(f'a {win}x{win} window leaves the {height}x{width} '
                         f'cache')
    index = index.astype(np.int32)
    dev = cache.device
    if dev.type == 'cpu':
        return plain_window_copy(cache, index, win)
    if dev.type != 'cuda':
        raise ValueError(f'no window copy for device {dev}')
    px_bytes = c * cache.element_size()
    if not cache.is_contiguous() or px_bytes % 4:
        raise ValueError(f'the window copy needs a contiguous cache of '
                         f'4-byte words a pixel, got {px_bytes} bytes')
    if ring and (px_bytes % 16 or cache.data_ptr() % 16):
        raise ValueError(f'the ring copies 16-byte words: a pixel of '
                         f'{px_bytes} bytes is not a whole number of them')
    out = torch.empty((index.shape[1], win, win, c), dtype=cache.dtype,
                      device=dev)
    lib = build.load('window_gather')
    fn = lib.mmlf_window_copy_launch
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p] * 2 + [ctypes.c_int] * 6 + \
        [ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p]
    idx = torch.from_numpy(np.ascontiguousarray(index)).to(dev)
    err = fn(cache.data_ptr(), idx.data_ptr(), index.shape[1], height, width,
             win, px_bytes, int(ring), out.data_ptr(), dev.index,
             torch.cuda.current_stream(dev).cuda_stream)
    build.check(lib, err, 'window copy kernel launch')
    if ring:
        window_copy.launches_ring += 1
    else:
        window_copy.launches += 1
    return out


window_copy.launches = 0
window_copy.launches_ring = 0
