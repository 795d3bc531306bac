"""Host seconds of the train pipeline's set-up in the run's process: the
program's ``mmlf.pipeline.shift`` (each scene's static shift) and
``mmlf.pipeline.pack`` (the device pyramid) from its span table, since
the set-up ends before the traced window starts."""

NAMES = ('mmlf.pipeline.shift', 'mmlf.pipeline.pack')


def read(run):
    try:
        from mmlf_tpu_torch import trace
    except ImportError:          # a program without spans
        return None
    totals = trace.totals()
    if not any(n in totals for n in NAMES):
        return None
    return sum(totals[n][0] for n in NAMES if n in totals)
