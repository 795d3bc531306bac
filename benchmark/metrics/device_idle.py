"""Share of the traced window in which no kernel, copy or set ran on the
card."""


def read(run):
    return run.trace.idle_pct() if run.trace is not None else None
