"""Host seconds a scene outside the ensemble: the traced window less the
benchmark's spans around ``ensemble_forward`` (the members and the
posterior, their device work included), over the scenes."""


def read(run):
    if run.trace is None or not run.units:
        return None
    spans = run.trace.span_s('ensemble_forward')
    if not spans:
        return None
    return (run.trace.window_s - sum(spans)) / run.units
