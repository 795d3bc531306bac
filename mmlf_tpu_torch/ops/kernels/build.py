"""Build the package's CUDA kernels with nvcc and load them with ctypes.

Each ``csrc/<name>.cu`` exposes a plain C interface and compiles alone into
``build/kernels/lib<name>-<digest>.so`` beside the package, for ``sm_90a``
(Hopper).  The digest covers the source, the ``csrc/*.cuh`` headers and the
flags, so an edited source or header rebuilds and a stale library is never
loaded.  Nothing builds at import:
the first launch of a kernel builds its library, and ``build_all`` starts
one nvcc per source at once.  A failed build raises with nvcc's output.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

PKG_DIR = Path(__file__).resolve().parents[2]
CSRC_DIR = PKG_DIR / 'csrc'
BUILD_DIR = PKG_DIR.parent / 'build' / 'kernels'
KERNELS = ('conv_block', 'posterior', 'window_gather')
NVCC_FLAGS = ('-gencode', 'arch=compute_90a,code=sm_90a', '-std=c++17',
              '-O3', '-shared', '-Xcompiler', '-fPIC', '-Xptxas', '-v')


def nvcc() -> str:
    """Path of nvcc: on PATH, else under $CUDA_HOME or the default CUDA
    install prefix."""
    found = shutil.which('nvcc')
    if found:
        return found
    for root in (os.environ.get('CUDA_HOME'), '/usr/local/cuda'):
        if root and os.path.exists(os.path.join(root, 'bin', 'nvcc')):
            return os.path.join(root, 'bin', 'nvcc')
    raise RuntimeError('nvcc not found (PATH, $CUDA_HOME, /usr/local/cuda); '
                       'the CUDA kernels of mmlf_tpu_torch cannot be built')


def library_path(name: str) -> Path:
    """Where the library of ``csrc/<name>.cu`` goes: its digest covers the
    source, every header under ``csrc`` (any source may include one) and
    the flags."""
    h = hashlib.sha256((CSRC_DIR / f'{name}.cu').read_bytes())
    for header in sorted(CSRC_DIR.glob('*.cuh')):
        h.update(header.name.encode() + header.read_bytes())
    h.update(' '.join(NVCC_FLAGS).encode())
    return BUILD_DIR / f'lib{name}-{h.hexdigest()[:16]}.so'


def _start(name: str):
    """Start nvcc for one kernel; returns (process, tmp, out) or None when
    the library is already built."""
    out = library_path(name)
    if out.exists():
        return None
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_name(f'{out.name}.{os.getpid()}.tmp')
    cmd = [nvcc(), *NVCC_FLAGS, '-o', str(tmp), str(CSRC_DIR / f'{name}.cu')]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)
    return proc, tmp, out


def _finish(name: str, started) -> Path:
    proc, tmp, out = started
    log, _ = proc.communicate()
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f'nvcc failed for csrc/{name}.cu '
                           f'(exit {proc.returncode}):\n{log}')
    out.with_name(out.name + '.log').write_text(log)
    os.replace(tmp, out)        # atomic: a reader never sees half a file
    return out


def build(name: str) -> Path:
    """Build one kernel library (if not built yet); returns its path."""
    started = _start(name)
    return library_path(name) if started is None else _finish(name, started)


def build_all(names=KERNELS) -> dict:
    """Build every kernel, one nvcc per source, all started together.
    Returns ``{name: library path}``."""
    started = {name: _start(name) for name in names}
    return {name: library_path(name) if s is None else _finish(name, s)
            for name, s in started.items()}


def ptxas_report(name: str) -> str:
    """nvcc's register/shared-memory report from the last build."""
    log = library_path(name).with_name(library_path(name).name + '.log')
    return log.read_text() if log.exists() else ''


@functools.cache
def load(name: str) -> ctypes.CDLL:
    """Build (if needed) and load one kernel library, once per process."""
    return ctypes.CDLL(str(build(name)))


def check(lib: ctypes.CDLL, err: int, what: str) -> None:
    """Raise if a launch returned a CUDA error code."""
    if err != 0:
        lib.mmlf_cuda_error_string.restype = ctypes.c_char_p
        lib.mmlf_cuda_error_string.argtypes = [ctypes.c_int]
        msg = lib.mmlf_cuda_error_string(err).decode()
        raise RuntimeError(f'{what}: CUDA error {err} ({msg})')
