"""Device milliseconds a train step of the work launched inside the
program's ``mmlf.train.backward`` spans (each microbatch's backward, from
autograd's thread while the step's thread waits inside the span)."""

from harness import program_spans


def read(run):
    return program_spans.device_ms(run, 'mmlf.train.backward')
