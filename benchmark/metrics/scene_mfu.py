"""Share of the configuration's peak of the ESE validation: the frozen
forward count (the net's ``flop_per_pixel``) of every member run (a
whole scene each) over the host clock's seconds of the traced window (its
``bench.window`` range), idle time included."""


def read(run):
    if run.trace is None or not getattr(run, 'members', 0):
        return None
    pc = run.config['port_config']
    size = run.traffic['scene_size']
    flop = run.net.flop_per_pixel(pc) * size * size
    return 100.0 * flop * run.members / run.trace.window_s / \
        run.config['peak_flops']
