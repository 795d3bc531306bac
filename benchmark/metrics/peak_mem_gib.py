"""Peak device memory allocated during the window (the statistics reset
at its start), in GiB."""


def read(run):
    return run.window_peak / 2 ** 30 if run.window_peak else None
