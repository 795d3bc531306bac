"""The window copies of ``scripts/gather_probe3.py`` and
``scripts/gather_probe4.py`` on the card.

    python -m mmlf_tpu_torch.probes.gather_probe probe3|probe4 [--device cpu]

Both scripts time one function at two cache layouts,

    out[b] = cache[scene[b], wy[b]:wy[b]+WIN, wx[b]:wx[b]+WIN, :]

copied HBM to HBM: probe3 from a ``(2, 512, 512, 27)`` float32 cache
(B 64, WIN 120, ``wx`` any integer), probe4 from a ``(2, 512, 512, 128)``
one (B 64, WIN 128, ``wx`` a multiple of 8).  Their Pallas kernels are
``pallas_gather`` (one DMA a window, started and waited on) and probe4's
``pallas_gather2`` (the DMA of window b + 1 started while window b is waited
on).  Here both are K1's window-copy configuration
(``ops/kernels/window_gather.window_copy``, ``csrc/window_gather.cu``):
``pallas_gather`` is the row-per-block copy, in 16-byte words at probe4's
512-byte pixels and in 4-byte words at probe3's 108-byte ones, and
``pallas_gather2`` the persistent two-slot bulk-copy ring (``ring=True``),
which takes 16-byte pixels only.  The scripts' reference,
``vmap(dynamic_slice)``, is one advanced-indexing call here; every copy
must equal it bit for bit.

Bound on an H100 SXM: bytes read plus written at 3.35 TB/s, 0.199 GB
(≥ 0.059 ms) at probe3 and 1.074 GB (≥ 0.321 ms) at probe4.
"""

from __future__ import annotations

import sys

import numpy as np
import torch

from ..ops.kernels.window_gather import plain_window_copy, window_copy
from ..utils.device import resolve_device
from . import cuda_ms

PEAK_BYTES = 3.35e12    # H100 SXM HBM bytes/s
# (scenes, H, W, C, WIN, B, wx multiple) of each script
PROBES = {'probe3': (2, 512, 512, 27, 120, 64, 1),
          'probe4': (2, 512, 512, 128, 128, 64, 8)}


def make_inputs(probe: str, device, seed: int = 0):
    """A seeded cache on ``device`` and the script's index draws (host
    int32 arrays): ``(cache, scene, ws_y, ws_x, win)``."""
    s, h, w, c, win, b, snap = PROBES[probe]
    rng = np.random.default_rng(seed)
    cache = torch.from_numpy(rng.random((s, h, w, c), dtype=np.float32))
    scene = rng.integers(0, s, b).astype(np.int32)
    ws_y = rng.integers(0, h - win, b).astype(np.int32)
    ws_x = (rng.integers(0, (w - win) // snap, b) * snap).astype(np.int32)
    return cache.to(device), scene, ws_y, ws_x, win


def indexed_windows(cache, scene, ws_y, ws_x, win: int):
    """The scripts' ``vmap(dynamic_slice)`` as one advanced-indexing call."""
    dev = cache.device
    s, wy, wx = (torch.as_tensor(np.asarray(a), dtype=torch.long,
                                 device=dev) for a in (scene, ws_y, ws_x))
    ar = torch.arange(win, device=dev)
    return cache[s[:, None, None], (wy[:, None] + ar)[:, :, None],
                 (wx[:, None] + ar)[:, None, :]]


def pallas_gather(cache, scene, ws_y, ws_x, win: int):
    """The scripts' ``pallas_gather``: one copy a window row."""
    return window_copy(cache, scene, ws_y, ws_x, win)


def pallas_gather2(cache, scene, ws_y, ws_x, win: int):
    """probe4's ``pallas_gather2``: the next window row's load overlaps the
    current one's store (on the CPU the same plain copy)."""
    return window_copy(cache, scene, ws_y, ws_x, win, ring=True)


def copy_bytes(cache, win: int, b: int) -> int:
    """Bytes read plus written by one copy of ``b`` windows."""
    return 2 * b * win * win * cache.shape[-1] * cache.element_size()


def run(probe: str, device='cuda', reps: int = 20) -> dict:
    """Check every copy of ``probe`` against the indexed windows (bit for
    bit) and, on the card, time each, the plain version and the indexing
    call.  Returns ``{name: {'ms', 'max_abs_err'}}`` plus ``plain_ms``,
    ``library_ms``, ``bound_ms`` and ``bytes``."""
    dev = resolve_device(device)
    cache, scene, ws_y, ws_x, win = make_inputs(probe, dev)
    want = indexed_windows(cache, scene, ws_y, ws_x, win)
    fns = {'pallas_gather': pallas_gather}
    if cache.shape[-1] * cache.element_size() % 16 == 0:
        fns['pallas_gather2'] = pallas_gather2
    index = np.stack([scene, ws_y, ws_x])
    out = {'bytes': copy_bytes(cache, win, len(scene))}
    out['bound_ms'] = out['bytes'] / PEAK_BYTES * 1e3
    for name, fn in fns.items():
        got = fn(cache, scene, ws_y, ws_x, win)
        equal = torch.equal(got, want)
        print(f'{probe} {name} equal: {equal}', flush=True)
        if not equal:
            raise AssertionError(f'{probe} {name} differs from the indexed '
                                 f'windows')
        out[name] = {'max_abs_err': float((got - want).abs().max())}
    if dev.type != 'cuda':
        return out
    timed = [(name, lambda fn=fn: fn(cache, scene, ws_y, ws_x, win))
             for name, fn in fns.items()]
    timed += [('plain', lambda: plain_window_copy(cache, index, win)),
              ('indexing', lambda: indexed_windows(cache, scene, ws_y, ws_x,
                                                   win))]
    for name, fn in timed:
        ms = cuda_ms(fn, reps)
        if name in fns:
            out[name]['ms'] = ms
        else:
            out['plain_ms' if name == 'plain' else 'library_ms'] = ms
        print(f'{probe} {name:16s} {ms:8.4f} ms  '
              f'{out["bytes"] / ms / 1e6:7.0f} GB/s (bound '
              f'{out["bound_ms"]:.4f} ms)', flush=True)
    return out


def main(argv) -> int:
    if not argv or argv[0] not in PROBES:
        print('usage: python -m mmlf_tpu_torch.probes.gather_probe '
              'probe3|probe4 [--device cpu]', file=sys.stderr)
        return 2
    device = argv[argv.index('--device') + 1] if '--device' in argv \
        else 'cuda'
    run(argv[0], device)
    return 0


if __name__ == '__main__':
    sys.exit(main(sys.argv[1:]))
