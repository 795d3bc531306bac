"""K3's share of its roofline over the window's train steps: the frozen
``k3_bound`` of the forward and backward of every conv block of the net's
``k3_blocks`` (bf16 operands at the bf16 peak, else 3xTF32) over the
device time of K3's kernels."""

from harness import peaks

K3_KERNELS = ('conv2x2_kernel', 'wgrad_kernel', 'plane_kernel',
              'sum_rows_kernel')


def read(run):
    if run.trace is None or not run.units:
        return None
    seconds = run.trace.kernel_s(K3_KERNELS)
    if seconds <= 0:
        return None
    pc = run.config['port_config']
    bf16 = bool(pc.get('bf16'))
    accum = int(pc['train_accum'])
    bound_ms = peaks.k3_step_bound_ms(
        run.net.k3_blocks(pc), pc['train_bs'] // accum, pc['train_ps'],
        accum, peaks.PEAK_BF16 if bf16 else peaks.PEAK_3XTF32,
        2 if bf16 else 4)
    return 100.0 * bound_ms * 1e-3 * run.units / seconds
