"""Share of the configuration's peak of the whole train step: the frozen
count of 3 × forward FLOP a step (the net's ``flop_per_pixel``) over
s/step, the seconds being the host clock's of the traced window (its
``bench.window`` range), idle time included."""


def read(run):
    if run.trace is None or not run.units:
        return None
    pc = run.config['port_config']
    flop = 3 * run.net.flop_per_pixel(pc) * pc['train_ps'] ** 2 * \
        pc['train_bs']
    return 100.0 * flop * run.units / run.trace.window_s / \
        run.config['peak_flops']
