"""Device milliseconds a train step of the work launched inside the
program's ``mmlf.train.augment`` spans (K1's cut and the augmentation of
each microbatch)."""

from harness import program_spans


def read(run):
    return program_spans.device_ms(run, 'mmlf.train.augment')
