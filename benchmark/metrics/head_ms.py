"""Device milliseconds a train step of the work launched inside the
program's ``mmlf.model.head`` spans: each microbatch's head on the
trunk's float32 output (UPR's mean, logvar and Laplace posterior; DPP's
scores, one-hot, softmax posterior and variance), its backward left
out."""

from harness import program_spans


def read(run):
    return program_spans.device_ms(run, 'mmlf.model.head')
