"""Host milliseconds of ``DevicePipeline.sample_batch`` a call, from the
benchmark's span around each call in the traced window."""


def read(run):
    if run.trace is None:
        return None
    spans = run.trace.span_s('sample')
    return 1e3 * sum(spans) / len(spans) if spans else None
