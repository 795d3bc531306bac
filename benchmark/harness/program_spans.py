"""What the metrics read from the program's own spans: the ``mmlf.*``
ranges that ``mmlf_tpu_torch/trace.py`` puts into the traced window.  A
program without a span gives None, not a zero."""

from __future__ import annotations

from .trace import _union


def device_ms(run, span: str):
    """Device milliseconds a unit of the work launched inside ``span``."""
    if run.trace is None or not run.units or not run.trace.span_s(span):
        return None
    return 1e3 * run.trace.launched_in(span) / run.units


def host_s(run, span: str):
    """Host seconds a unit inside ``span``."""
    spans = [] if run.trace is None or not run.units else \
        run.trace.span_s(span)
    return sum(spans) / run.units if spans else None


def count(run, span: str):
    """Ranges of ``span`` a unit."""
    spans = [] if run.trace is None or not run.units else \
        run.trace.span_s(span)
    return len(spans) / run.units if spans else None


def idle_ms(run, prefix: str):
    """Device idle milliseconds a unit while the host was inside any span
    whose name starts with ``prefix`` (each instant once, whatever span,
    the program's or torch's own, is innermost there)."""
    if run.trace is None or not run.units:
        return None
    t = run.trace
    inside = _union((max(float(e['ts']), t.t0),
                     min(float(e['ts']) + float(e['dur']), t.t1))
                    for e in t.spans if e['name'].startswith(prefix))
    inside = [(s, e) for s, e in inside if e > s]
    if not inside:
        return None
    idle, prev = [], t.t0
    for s, e in t._busy() + [[t.t1, t.t1]]:
        if s > prev:
            idle.append((prev, s))
        prev = max(prev, e)
    overlap, j = 0.0, 0
    for s, e in inside:              # both lists sorted and disjoint
        while j < len(idle) and idle[j][1] <= s:
            j += 1
        k = j
        while k < len(idle) and idle[k][0] < e:
            overlap += min(e, idle[k][1]) - max(s, idle[k][0])
            k += 1
    return 1e-3 * overlap / run.units
