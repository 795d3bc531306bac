"""Host seconds a scene inside the program's ``mmlf.val.save`` spans (the
artifacts written, the scene's second decode included)."""

from harness import program_spans


def read(run):
    return program_spans.host_s(run, 'mmlf.val.save')
