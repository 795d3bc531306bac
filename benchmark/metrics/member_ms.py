"""Device milliseconds of one ensemble member: the device time of the work
launched inside ``ensemble_forward`` less that of the posterior call, over
the members run."""


def read(run):
    if run.trace is None or not getattr(run, 'members', 0):
        return None
    seconds = run.trace.launched_in('ensemble_forward') - \
        run.trace.launched_in('posterior')
    return 1e3 * seconds / run.members if seconds > 0 else None
