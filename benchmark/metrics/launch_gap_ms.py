"""Device idle milliseconds a train step while the host was inside the
program's train step (any ``mmlf.train.*`` span): the card waiting for
the step's launches."""

from harness import program_spans


def read(run):
    return program_spans.idle_ms(run, 'mmlf.train.')
