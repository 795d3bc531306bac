"""Device milliseconds a train step of the work launched inside the
program's ``mmlf.train.targets`` spans: each microbatch's train mask and
targets (DPP's soft targets from the MPI, plane by plane)."""

from harness import program_spans


def read(run):
    return program_spans.device_ms(run, 'mmlf.train.targets')
