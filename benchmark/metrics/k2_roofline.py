"""K2's share of its roofline: the frozen ``posterior_bound`` at K members,
a whole scene's pixels and K bins, a launch, over the device time of K2's
kernel."""

import numpy as np

from harness import peaks


def read(run):
    if run.trace is None:
        return None
    launches = run.launches.get('laplace_mixture_posterior', 0)
    seconds = run.trace.kernel_s(('mixture_posterior_kernel',))
    if not launches or seconds <= 0:
        return None
    t = run.traffic
    k = len(np.arange(t['disp_min'], t['disp_max'], t['disp_step'],
                      dtype=np.float32))
    ms, _ = peaks.posterior_bound(k, t['scene_size'] ** 2, k)
    return 100.0 * ms * 1e-3 * launches / seconds
