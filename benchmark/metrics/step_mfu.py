"""Share of the configuration's peak of the whole train step: the frozen
count of 3 × forward FLOP a step over s/step, the seconds being the host
clock's of the traced window (its ``bench.window`` range), idle time
included."""

from harness import peaks


def read(run):
    if run.trace is None or not run.units:
        return None
    pc = run.config['port_config']
    flop = 3 * peaks.conv_flop_per_pixel(
        pc['model_chs'], pc['model_views'], pc['model_in_blocks'],
        pc['model_out_blocks']) * pc['train_ps'] ** 2 * pc['train_bs']
    return 100.0 * flop * run.units / run.trace.window_s / \
        run.config['peak_flops']
