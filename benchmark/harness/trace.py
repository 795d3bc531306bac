"""Spans of the benchmark's own, and the reduction of a ``torch.profiler``
trace (CPU + CUDA) to device busy time, kernel time by name, device time
by the span that launched it, and idle device time by the span the host
was in."""

from __future__ import annotations

import collections
import contextlib
import json
import os
import tempfile
import time

WINDOW = 'bench.window'
DEVICE_CATS = ('kernel', 'gpu_memcpy', 'gpu_memset')


class Spans:
    """Host-clock spans ``(name, start, end)`` around calls into the
    program; with ``traced`` each is also a ``record_function`` range, so
    the trace carries it on the device's timeline."""

    def __init__(self, traced: bool = False):
        self.traced = traced
        self.records = []

    @contextlib.contextmanager
    def __call__(self, name: str):
        ctx = contextlib.nullcontext()
        if self.traced:
            import torch
            ctx = torch.profiler.record_function(name)
        t0 = time.perf_counter()
        with ctx:
            yield
        self.records.append((name, t0, time.perf_counter()))


def start_profiler():
    import torch
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    prof = torch.profiler.profile(activities=activities)
    prof.__enter__()
    return prof


def stop_profiler(prof) -> list:
    """Stop ``prof`` and return its chrome-trace events (written to a
    temporary file under ``TMPDIR`` and read back)."""
    import torch
    if torch.cuda.is_available():
        torch.cuda.synchronize()
    prof.__exit__(None, None, None)
    fd, path = tempfile.mkstemp(suffix='.json')
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        with open(path) as f:
            return json.load(f)['traceEvents']
    finally:
        os.remove(path)


def _union(intervals):
    """Merge ``(start, end)`` intervals; returns the sorted disjoint list."""
    out = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return out


class Trace:
    """One traced window, times in seconds.

    ``window_s``: the ``bench.window`` range; ``busy_s``: the union of
    device kernel, copy and set intervals inside it; ``kernel_s(names)``:
    device time of the kernels whose name contains one of ``names``;
    ``launched_in(span)``: device time of the work launched while the host
    was inside a span of that name; ``device_ops()`` and ``idle_gaps()``:
    the breakdown's two lists."""

    def __init__(self, events: list):
        xs = [e for e in events if e.get('ph') == 'X' and 'dur' in e]
        win = [e for e in xs if e.get('name') == WINDOW and
               e.get('cat') == 'user_annotation']
        if not win:
            raise ValueError('the trace holds no bench.window range')
        w = win[0]
        self.t0, self.t1 = float(w['ts']), float(w['ts']) + float(w['dur'])
        self.device = [e for e in xs if e.get('cat') in DEVICE_CATS and
                       self.t0 <= float(e['ts']) < self.t1]
        self.spans = [e for e in xs if e.get('cat') == 'user_annotation'
                      and e.get('name') != WINDOW]
        # the host call that launched each device operation: the earliest
        # CUDA API event with its correlation id
        launches = {}
        for e in xs:
            corr = e.get('args', {}).get('correlation')
            if corr is not None and str(e.get('cat', '')).startswith('cuda_'):
                launches[corr] = min(launches.get(corr, float('inf')),
                                     float(e['ts']))
        self.launch_ts = launches

    @property
    def window_s(self) -> float:
        return (self.t1 - self.t0) * 1e-6

    def _busy(self):
        return _union((max(float(e['ts']), self.t0),
                       min(float(e['ts']) + float(e['dur']), self.t1))
                      for e in self.device)

    @property
    def busy_s(self) -> float:
        return sum(e - s for s, e in self._busy()) * 1e-6

    def idle_pct(self):
        """Share of the window in which nothing ran on the card, in %
        (None for an empty window)."""
        if self.window_s <= 0:
            return None
        return 100.0 * (1.0 - self.busy_s / self.window_s)

    def kernel_s(self, names) -> float:
        return sum(float(e['dur']) for e in self.device
                   if e.get('cat') == 'kernel' and
                   any(n in e.get('name', '') for n in names)) * 1e-6

    def _span_at(self, ts: float):
        """The innermost benchmark span around host time ``ts``."""
        best = None
        for e in self.spans:
            s = float(e['ts'])
            if s <= ts < s + float(e['dur']) and (
                    best is None or float(e['dur']) < float(best['dur'])):
                best = e
        return None if best is None else best['name']

    def launched_in(self, span: str) -> float:
        """Device seconds of the work launched inside ``span``."""
        ranges = [(float(e['ts']), float(e['ts']) + float(e['dur']))
                  for e in self.spans if e['name'] == span]
        total = 0.0
        for e in self.device:
            ts = self.launch_ts.get(e.get('args', {}).get('correlation'))
            if ts is not None and any(s <= ts < t for s, t in ranges):
                total += float(e['dur'])
        return total * 1e-6

    def span_s(self, name: str):
        """Durations of the spans called ``name`` inside the window."""
        return [float(e['dur']) * 1e-6 for e in self.spans
                if e['name'] == name and self.t0 <= float(e['ts']) < self.t1]

    def device_ops(self, top: int = 10):
        by = collections.Counter()
        for e in self.device:
            by[e.get('name', '?')] += float(e['dur']) * 1e-6
        return [[n, s] for n, s in by.most_common(top)]

    def idle_gaps(self, top: int = 10):
        """Idle device time inside the window, summed by the span the host
        was in (the innermost; ``host`` outside every span): each gap is
        cut at the spans' ends and each piece named by the span around
        it."""
        by = collections.Counter()
        gaps, prev = [], self.t0
        for s, e in self._busy() + [[self.t1, self.t1]]:
            if s > prev:
                gaps.append((prev, s))
            prev = max(prev, e)
        for g0, g1 in gaps:
            cuts = sorted({g0, g1} | {
                t for e in self.spans
                for t in (float(e['ts']), float(e['ts']) + float(e['dur']))
                if g0 < t < g1})
            for a, b in zip(cuts, cuts[1:]):
                by[self._span_at((a + b) / 2) or 'host'] += (b - a) * 1e-6
        return [[n, s] for n, s in by.most_common(top)]
