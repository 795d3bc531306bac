"""The readers of the program's own spans (``mmlf.*``) on hand-made
traces with known kernel, idle and span times; the benchmark's own span
readers read the same with and without the program's ranges nested in
their spans; a program without spans gives no value."""

import itertools
import sys
import types

import pytest

import run
from harness.trace import WINDOW, Trace

CORRELATION = itertools.count(1)


def ev(cat, name, ts, dur, corr=None):
    e = {'ph': 'X', 'cat': cat, 'name': name, 'ts': ts, 'dur': dur}
    if corr is not None:
        e['args'] = {'correlation': corr}
    return e


def span(name, ts, dur):
    return ev('user_annotation', name, ts, dur)


def launch(ts, dur_on_card, at, kernel='k'):
    """A launch at host time ``ts`` of a kernel running ``[at, at +
    dur_on_card)`` on the card."""
    corr = next(CORRELATION)
    return [ev('cuda_runtime', 'cudaLaunchKernel', ts, 1, corr=corr),
            ev('kernel', kernel, at, dur_on_card, corr=corr)]


def train_events(program: bool):
    """Two 500-us steps; in each the benchmark's ``sample`` and
    ``train_step``, the program's step and its four phases, torch's own
    Adam range inside the optimizer's, one kernel a phase."""
    out = [span(WINDOW, 0, 1000)]
    for o in (0, 500):
        out += [span('sample', o, 4), span('train_step', o + 4, 490),
                span('Optimizer.step#Adam.step', o + 310, 80)]
        if program:
            out += [span('mmlf.train.step', o + 5, 485),
                    span('mmlf.train.augment', o + 6, 14),
                    span('mmlf.train.forward', o + 20, 80),
                    span('mmlf.train.backward', o + 100, 200),
                    span('mmlf.train.optimizer', o + 300, 100)]
        out += launch(o + 7, 10, o + 10)          # augment: 10 us
        out += launch(o + 25, 60, o + 30)         # forward: 60
        out += launch(o + 105, 150, o + 110)      # backward: 150
        out += launch(o + 320, 40, o + 320)       # Adam: 40
    return out


def ese_events(program: bool):
    """Two 500-us scenes: load (its decode), the ensemble (one member
    kernel and the posterior's), readback, calibration, save (a second
    decode); the benchmark's spans as its patches place them."""
    out = [span(WINDOW, 0, 1000)]
    for o in (0, 500):
        out += [span('load', o + 1, 89),
                span('ensemble_forward', o + 100, 150),
                span('posterior', o + 230, 9),
                span('calibration', o + 261, 38),
                span('save', o + 301, 178), span('load', o + 302, 88)]
        if program:
            out += [span('mmlf.val.load', o, 100),
                    span('mmlf.data.load_scene', o + 2, 78),
                    span('mmlf.val.members', o + 101, 139),
                    span('mmlf.val.readback', o + 250, 10),
                    span('mmlf.val.calibration', o + 260, 40),
                    span('mmlf.val.save', o + 300, 180),
                    span('mmlf.data.load_scene', o + 303, 77)]
        out += launch(o + 95, 10, o + 96)                     # the H2D copy
        out += launch(o + 110, 80, o + 120)                   # members
        out += launch(o + 231, 5, o + 235, 'mixture_posterior_kernel')
    return out


def reading(cell, events, also=(), **run_fields):
    """The cell's metrics read from the program's or the benchmark's
    spans (and those named in ``also``) on a trace of ``events``."""
    r = types.SimpleNamespace(trace=Trace(events), units=2, **run_fields)
    return {name: read(r)
            for name, (m, read) in run.resolve(cell)[4].items()
            if m['source'] == 'program_span' or name in also}


def test_train_readers():
    got = reading('upr_bf16_trunk.train', train_events(True))
    assert got['augment_ms.train'] == pytest.approx(10e-3)
    assert got['fwd_ms.train'] == pytest.approx(60e-3)
    assert got['bwd_ms.train'] == pytest.approx(150e-3)
    # the Adam kernel launched inside torch's range, inside the program's
    assert got['optim_ms.train'] == pytest.approx(40e-3)
    # idle in [5, 490) of each step: 5 + 10 + 20 + 60 + 130
    assert got['launch_gap_ms.train'] == pytest.approx(225e-3)
    fp32 = reading('upr_fp32.train', train_events(True))
    assert fp32['fwd_ms.train_fp32'] == pytest.approx(60e-3)
    assert fp32['bwd_ms.train_fp32'] == pytest.approx(150e-3)


def test_ese_readers():
    got = reading('upr_fp32.ese', ese_events(True), members=2)
    assert got['load_s.ese'] == pytest.approx(100e-6)
    assert got['save_s.ese'] == pytest.approx(180e-6)
    assert got['calib_s.ese'] == pytest.approx(40e-6)
    assert got['loads_per_scene.ese'] == pytest.approx(2.0)


@pytest.mark.parametrize('cell,fields,names', [
    ('upr_bf16_trunk.train', {}, ['sample_ms.train']),
    ('upr_fp32.ese', {'members': 2}, ['host_s.ese', 'member_ms.ese'])])
def test_benchmark_spans_read_the_same(cell, fields, names):
    events = train_events if cell.endswith('.train') else ese_events
    bare = reading(cell, events(False), names, **fields)
    spanned = reading(cell, events(True), names, **fields)
    for name in names:
        assert bare[name] is not None
        assert spanned[name] == pytest.approx(bare[name]), name
    # the values themselves: 4 us a sample; (1000 - 2 x 150) / 2 us a
    # scene outside the ensemble; 80 us of members a member
    want = {'sample_ms.train': 4e-3, 'host_s.ese': 350e-6,
            'member_ms.ese': 80e-3}
    assert {n: spanned[n] for n in names} == pytest.approx(
        {n: want[n] for n in names})


@pytest.mark.parametrize('cell,events', [
    ('upr_bf16_trunk.train', train_events),
    ('upr_fp32.train', train_events), ('upr_fp32.ese', ese_events)])
def test_a_program_without_spans_reads_nothing(cell, events, monkeypatch):
    import mmlf_tpu_torch
    monkeypatch.delattr(mmlf_tpu_torch, 'trace', raising=False)
    monkeypatch.setitem(sys.modules, 'mmlf_tpu_torch.trace', None)
    got = reading(cell, events(False), members=2)
    new = set(got) - {'sample_ms.train', 'sample_ms.train_fp32',
                      'host_s.ese'}
    assert new and all(got[name] is None for name in new)


def test_pipeline_setup_reads_the_span_table(monkeypatch):
    from mmlf_tpu_torch import trace
    monkeypatch.setattr(trace, 'totals', lambda: {
        'mmlf.pipeline.shift': (20.5, 16), 'mmlf.pipeline.pack': (12.25, 1),
        'mmlf.data.load_scene': (3.0, 16)})
    for cell in ('upr_bf16_trunk.train', 'upr_fp32.train'):
        got = reading(cell, train_events(True))
        assert got['pipeline_setup_s.train'] == pytest.approx(32.75)
    monkeypatch.setattr(trace, 'totals', lambda: {})
    assert reading('upr_fp32.train', train_events(True))[
        'pipeline_setup_s.train'] is None
