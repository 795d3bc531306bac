"""Named spans of the port's own work, on the profiler's clock.

``span(name)`` is a context manager and a decorator.  It adds the host
seconds of its block and a count to this process's table, read by
``totals()`` and cleared by ``reset()``: the only record of the set-up
phases, which end before a profiler is started for a measured window.
While a ``torch.profiler`` (or ``torch.autograd.profiler``) records, the
span is also a ``record_function`` range, so the chrome trace holds it as
a ``user_annotation`` on the clock of the kernels it launched; a parent
and its child follow from nesting on one thread.  With no profiler it
costs one flag read and two clock reads.  There is no switch of its own:
tracing is on exactly while a profiler records (``--train_profile``, an
operator's own profiler, the benchmark's ``--trace 1``).

Every name starts with ``mmlf.``: ``mmlf.<layer>.<phase>``.
"""

from __future__ import annotations

import collections
import contextlib
import threading
import time

import torch
from torch.autograd import profiler as _profiler

_TOTALS: dict = collections.defaultdict(lambda: [0.0, 0])
_LOCK = threading.Lock()


@contextlib.contextmanager
def span(name: str):
    """Time the block (or each call of the decorated function) as
    ``name``; a ``record_function`` range too while a profiler records."""
    ctx = torch.profiler.record_function(name) \
        if _profiler._is_profiler_enabled else contextlib.nullcontext()
    t0 = time.perf_counter()
    try:
        with ctx:
            yield
    finally:
        seconds = time.perf_counter() - t0
        with _LOCK:
            entry = _TOTALS[name]
            entry[0] += seconds
            entry[1] += 1


def totals() -> dict:
    """``{name: (host seconds, count)}`` of every span closed in this
    process since the last ``reset()``."""
    with _LOCK:
        return {k: (v[0], v[1]) for k, v in _TOTALS.items()}


def reset() -> None:
    with _LOCK:
        _TOTALS.clear()
