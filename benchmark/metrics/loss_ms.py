"""Device milliseconds a train step of the work launched inside the
program's ``mmlf.train.loss`` spans: each microbatch's loss forward
(UPR's heteroscedastic L1, DPP's cross-entropy), its backward left
out."""

from harness import program_spans


def read(run):
    return program_spans.device_ms(run, 'mmlf.train.loss')
