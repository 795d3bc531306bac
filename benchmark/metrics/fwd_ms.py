"""Device milliseconds a train step of the work launched inside the
program's ``mmlf.train.forward`` spans (each microbatch's model, targets
and loss)."""

from harness import program_spans


def read(run):
    return program_spans.device_ms(run, 'mmlf.train.forward')
