"""K1's share of its roofline: the frozen ``window_gather_bound`` (every
window byte read and written once, image bytes of the cache's dtype, the
MPI field only for a net whose loss reads it: UPR's reads none) of each
launch over the device time of K1's kernel."""

from harness import peaks


def read(run):
    if run.trace is None:
        return None
    launches = run.launches.get('window_gather', 0) + \
        run.launches.get('window_gather_bf16', 0)
    seconds = run.trace.kernel_s(('window_gather_kernel',))
    if not launches or seconds <= 0:
        return None
    pc = run.config['port_config']
    ps, views = pc['train_ps'], pc['model_views']
    win = (ps + 16 + 2 * 8 + 15) // 16 * 16
    ci = (4 * views * 3 + 127) // 128 * 128
    ms, _ = peaks.window_gather_bound(
        pc['train_bs'] // int(pc['train_accum']), win, ci,
        run.net.USES_MPI, 2 if pc.get('cache_bf16') else 4)
    return 100.0 * ms * 1e-3 * launches / seconds
