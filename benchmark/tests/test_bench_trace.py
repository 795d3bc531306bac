"""The trace reduction on a hand-made trace."""

import pytest

from harness.trace import WINDOW, Trace


def ev(cat, name, ts, dur, corr=None):
    e = {'ph': 'X', 'cat': cat, 'name': name, 'ts': ts, 'dur': dur}
    if corr is not None:
        e['args'] = {'correlation': corr}
    return e


EVENTS = [
    ev('user_annotation', WINDOW, 0, 100),
    ev('user_annotation', 'ensemble_forward', 0, 60),
    ev('user_annotation', 'posterior', 50, 10),
    ev('cuda_runtime', 'cudaLaunchKernel', 1, 1, corr=1),
    ev('cuda_runtime', 'cudaLaunchKernel', 2, 1, corr=2),
    ev('cuda_runtime', 'cudaLaunchKernel', 51, 1, corr=3),
    ev('kernel', 'conv_kernel', 10, 20, corr=1),
    ev('kernel', 'conv_kernel', 25, 15, corr=2),
    ev('kernel', 'mixture_posterior_kernel', 55, 5, corr=3),
    ev('gpu_memcpy', 'Memcpy DtoH', 80, 10),
    ev('kernel', 'outside', 150, 10),
]


def test_busy_and_window():
    t = Trace(EVENTS)
    assert t.window_s == pytest.approx(100e-6)
    # [10, 40) ∪ [55, 60) ∪ [80, 90)
    assert t.busy_s == pytest.approx(45e-6)
    assert t.kernel_s(('mixture_posterior',)) == pytest.approx(5e-6)


def test_launched_in_spans():
    t = Trace(EVENTS)
    assert t.launched_in('ensemble_forward') == pytest.approx(40e-6)
    assert t.launched_in('posterior') == pytest.approx(5e-6)
    assert t.span_s('posterior') == [pytest.approx(10e-6)]


def test_breakdown():
    t = Trace(EVENTS)
    ops = dict(t.device_ops())
    assert ops['conv_kernel'] == pytest.approx(35e-6)
    assert 'outside' not in ops
    gaps = dict(t.idle_gaps())
    # [0, 10) and [40, 50) in ensemble_forward, [50, 55) in posterior,
    # [60, 80) and [90, 100) outside every span
    assert gaps['ensemble_forward'] == pytest.approx(20e-6)
    assert gaps['posterior'] == pytest.approx(5e-6)
    assert gaps['host'] == pytest.approx(30e-6)
