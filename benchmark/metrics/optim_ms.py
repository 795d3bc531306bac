"""Device milliseconds a train step of the work launched inside the
program's ``mmlf.train.optimizer`` span (the gradient sum across ranks,
where there are several, and Adam)."""

from harness import program_spans


def read(run):
    return program_spans.device_ms(run, 'mmlf.train.optimizer')
