"""Host seconds a scene inside the program's ``mmlf.val.load`` spans (the
scene read, decoded, masked and shifted, and copied to the card)."""

from harness import program_spans


def read(run):
    return program_spans.host_s(run, 'mmlf.val.load')
