"""Scene decodes a validated scene: the program's ``mmlf.data.load_scene``
ranges in the window over the scenes (1 would be each scene read once)."""

from harness import program_spans


def read(run):
    return program_spans.count(run, 'mmlf.data.load_scene')
