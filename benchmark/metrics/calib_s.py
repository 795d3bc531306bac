"""Host seconds a scene inside the program's ``mmlf.val.calibration``
spans (the ESE calibration guard's per-scene statistics)."""

from harness import program_spans


def read(run):
    return program_spans.host_s(run, 'mmlf.val.calibration')
