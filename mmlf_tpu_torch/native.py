"""ctypes bindings of the port's host library (``csrc_host/mmlf_native.cpp``).

The counterpart of ``mmlf_tpu.native``: the multithreaded texture mask and
the stride-f window cutter of the host training pipeline.  The library is
the port's own copy of the C++ source, built by g++ at first use into
``build/host/libmmlf_native-<digest>.so`` beside the package; the digest
covers the source, the flags and the host CPU that ``-march=native``
resolves to, so a library built on another machine is never loaded.
Nothing builds at import.

Every entry point returns None when the library is unavailable (no g++, a
failed build, or ``MMLF_TORCH_NO_NATIVE`` set), and the callers take their
numpy versions, as the JAX package does.  A failed build warns once;
``build()`` raises with g++'s output, for callers that need the library.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import subprocess
import threading
import warnings
from pathlib import Path

import numpy as np

PKG_DIR = Path(__file__).resolve().parent
SOURCE = PKG_DIR / 'csrc_host' / 'mmlf_native.cpp'
BUILD_DIR = PKG_DIR.parent / 'build' / 'host'
# no -ffast-math: the mask's sums keep their order and its norm stays one
# multiply, so the mask equals the JAX package's native one bit for bit
CXX_FLAGS = ('-O3', '-march=native', '-ffp-contract=off', '-fPIC', '-shared',
             '-std=c++17', '-pthread')
DISABLE_ENV = 'MMLF_TORCH_NO_NATIVE'


@functools.cache
def _cpu_key() -> str:
    """The target options ``-march=native`` resolves to on this host, as
    g++ passes them on to its compiler proper."""
    proc = subprocess.run(['g++', '-march=native', '-###', '-x', 'c++', '-c',
                           os.devnull, '-o', os.devnull],
                          capture_output=True, text=True, timeout=60)
    lines = [ln for ln in proc.stderr.splitlines() if '-march=' in ln]
    if proc.returncode != 0 or not lines:
        raise RuntimeError(f'g++ -march=native failed (exit '
                           f'{proc.returncode}):\n{proc.stderr}')
    return lines[-1].split('-march=', 1)[1]


def library_path() -> Path:
    """Where the library goes: its digest covers the source, the flags and
    the host CPU."""
    h = hashlib.sha256(SOURCE.read_bytes())
    h.update(' '.join(CXX_FLAGS).encode())
    h.update(_cpu_key().encode())
    return BUILD_DIR / f'libmmlf_native-{h.hexdigest()[:16]}.so'


def build() -> Path:
    """Build the library (if not built yet) and return its path; raises with
    g++'s output when the build fails."""
    try:
        out = library_path()
    except (OSError, subprocess.SubprocessError) as e:
        raise RuntimeError(f'g++ is not usable: {e}') from e
    if out.exists():
        return out
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f'{out.name}.{os.getpid()}.tmp')
    proc = subprocess.run(['g++', *CXX_FLAGS, '-o', str(tmp), str(SOURCE)],
                          capture_output=True, text=True, timeout=300)
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f'g++ failed for {SOURCE.name} (exit '
                           f'{proc.returncode}):\n{proc.stdout}'
                           f'{proc.stderr}')
    os.replace(tmp, out)        # atomic: a reader never sees half a file
    return out


class _Loaded:
    """The process's library: loaded once, or None once that failed."""
    lock = threading.Lock()
    lib = None
    tried = False
    path = None


def get_lib():
    """The loaded library, or None when it is unavailable."""
    if _Loaded.tried:
        return _Loaded.lib
    with _Loaded.lock:
        if _Loaded.tried:
            return _Loaded.lib
        _Loaded.tried = True
        if os.environ.get(DISABLE_ENV):
            return None
        try:
            path = build()
        except RuntimeError as e:
            warnings.warn(f'mmlf_tpu_torch host library unavailable, numpy '
                          f'fallbacks in use: {e}', RuntimeWarning)
            return None
        lib = ctypes.CDLL(str(path))
        lib.texture_mask.argtypes = [
            ctypes.POINTER(ctypes.c_float), ctypes.c_int, ctypes.c_int,
            ctypes.c_int, ctypes.c_float, ctypes.POINTER(ctypes.c_int32)]
        lib.texture_mask.restype = None
        lib.strided_window.argtypes = [
            ctypes.POINTER(ctypes.c_float)] + [ctypes.c_int64] * 8 + [
            ctypes.POINTER(ctypes.c_float)]
        lib.strided_window.restype = None
        _Loaded.lib, _Loaded.path = lib, path
        return lib


def loaded_path():
    """Path of the loaded library, or None."""
    get_lib()
    return _Loaded.path


def reset() -> None:
    """Forget the loaded library, so the next call decides again (tests
    toggle ``MMLF_TORCH_NO_NATIVE``)."""
    with _Loaded.lock:
        _Loaded.lib = _Loaded.path = None
        _Loaded.tried = False


def texture_mask(center: np.ndarray, wsize: int,
                 threshold: float) -> 'np.ndarray | None':
    """Native MAD texture mask of an ``(H, W, 3)`` centre view, or None when
    the library is unavailable or the view is not RGB."""
    lib = get_lib()
    if lib is None:
        return None
    center = np.ascontiguousarray(center, dtype=np.float32)
    if center.ndim != 3 or center.shape[2] != 3:
        return None
    h, w, _ = center.shape
    out = np.empty((h, w), dtype=np.int32)
    lib.texture_mask(
        center.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        h, w, int(wsize), ctypes.c_float(threshold),
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)))
    return out


def strided_window(src: np.ndarray, ws_y: int, ws_x: int, f: int,
                   win: int) -> 'np.ndarray | None':
    """Native stride-f window cut ``src[:, ::f, ::f][:, ws_y:ws_y+win,
    ws_x:ws_x+win]`` of an ``(A, H, W, C)`` C-contiguous float32 array, or
    None when the library is unavailable or the array is of another kind.
    Raises for a window that leaves the strided array."""
    lib = get_lib()
    if lib is None or src.dtype != np.float32 or src.ndim != 4 or \
            not src.flags.c_contiguous:
        return None
    a, h, w, c = src.shape
    if f < 1 or win < 1 or ws_y < 0 or ws_x < 0 or \
            ws_y + win > -(-h // f) or ws_x + win > -(-w // f):
        raise ValueError(f'window ({ws_y}, {ws_x}) + {win} at stride {f} '
                         f'leaves a {h}x{w} array')
    dst = np.empty((a, win, win, c), dtype=np.float32)
    lib.strided_window(
        src.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        a, h, w, c, int(ws_y), int(ws_x), int(f), int(win),
        dst.ctypes.data_as(ctypes.POINTER(ctypes.c_float)))
    return dst
