"""The port's spans (``mmlf_tpu_torch/trace.py``): no ``record_function``
without a profiler, ``user_annotation`` ranges nested as written under
one, the spans of a train step with two microbatches and of an ESE
validation of one scene, and every name under ``mmlf.``."""

import json
import os
import re

import pytest
import torch

from mmlf_tpu_torch import trace
from mmlf_tpu_torch.config import Config
from mmlf_tpu_torch.data.hci4d import HCI4D
from mmlf_tpu_torch.data.pipeline import DevicePipeline
from mmlf_tpu_torch.data.synth import generate_dataset
from mmlf_tpu_torch.models import build_model
from mmlf_tpu_torch.models.feed_forward import init_live_
from mmlf_tpu_torch.train import loop
from mmlf_tpu_torch.utils.convert import save_checkpoint_pt
from mmlf_tpu_torch.validate.cli import run_validation

import torch_threads  # noqa: F401  torch's share of the CPUs under xdist

PACKAGE = os.path.dirname(trace.__file__)
SMALL = dict(model_chs=4, model_in_blocks=1, model_out_blocks=1,
             model_uncert=True)
# the names the benchmark's readers look up (benchmark/metrics/)
NAMES = {'mmlf.train.step', 'mmlf.train.augment', 'mmlf.train.forward',
         'mmlf.train.targets', 'mmlf.train.loss', 'mmlf.model.head',
         'mmlf.train.backward', 'mmlf.train.optimizer',
         'mmlf.pipeline.shift', 'mmlf.pipeline.pack', 'mmlf.data.load_scene',
         'mmlf.val.load', 'mmlf.val.members', 'mmlf.val.readback',
         'mmlf.val.calibration', 'mmlf.val.save'}


@pytest.fixture(scope='module')
def scene_dir(tmp_path_factory):
    root = str(tmp_path_factory.mktemp('torch_trace'))
    generate_dataset(root, scenes=1, size=64, seed=3)
    return root


def profiled(fn, tmp_path):
    """``fn()`` under a CPU ``torch.profiler``; returns the exported
    trace's ``mmlf.*`` ranges as ``(name, start, end)`` in start order."""
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        fn()
    path = str(tmp_path / 'trace.json')
    prof.export_chrome_trace(path)
    with open(path) as f:
        events = json.load(f)['traceEvents']
    ours = [e for e in events if e.get('ph') == 'X' and
            e.get('name', '').startswith('mmlf.')]
    assert all(e['cat'] == 'user_annotation' for e in ours)
    return sorted(((e['name'], float(e['ts']), float(e['ts']) + e['dur'])
                   for e in ours), key=lambda r: r[1])


def inside(child, parents) -> bool:
    return any(p[1] <= child[1] and child[2] <= p[2] for p in parents)


def of(ranges, name):
    return [r for r in ranges if r[0] == name]


def test_no_profiler_no_record_function(monkeypatch):
    def refuse(name):
        raise AssertionError(f'record_function({name!r}) without a profiler')

    monkeypatch.setattr(torch.profiler, 'record_function', refuse)
    trace.reset()
    with trace.span('mmlf.test.outer'):
        with trace.span('mmlf.test.inner'):
            pass

    @trace.span('mmlf.test.fn')
    def fn(x):
        return x + 1

    assert fn(1) == 2 and fn(2) == 3
    got = trace.totals()
    assert {k: n for k, (_, n) in got.items()} == {
        'mmlf.test.outer': 1, 'mmlf.test.inner': 1, 'mmlf.test.fn': 2}
    assert got['mmlf.test.outer'][0] >= got['mmlf.test.inner'][0] >= 0
    trace.reset()
    assert trace.totals() == {}


def test_ranges_nest_as_written(tmp_path):
    def work():
        with trace.span('mmlf.test.a'):
            with trace.span('mmlf.test.b'):
                with trace.span('mmlf.test.c'):
                    torch.ones(8).sum()
            with trace.span('mmlf.test.b'):
                pass

    ranges = profiled(work, tmp_path)
    assert [r[0] for r in ranges] == ['mmlf.test.a', 'mmlf.test.b',
                                      'mmlf.test.c', 'mmlf.test.b']
    a, b, c = of(ranges, 'mmlf.test.a'), of(ranges, 'mmlf.test.b'), \
        of(ranges, 'mmlf.test.c')
    assert all(inside(r, a) for r in b) and inside(c[0], b[:1])
    assert not inside(c[0], b[1:])


def test_train_step_spans(scene_dir, tmp_path):
    cfg = Config(train_trainset=scene_dir, train_bs=4, train_accum=2,
                 train_ps=32, train_max_downscale=1, train_shift=0.5,
                 **SMALL).finalize()
    trace.reset()
    pipe = DevicePipeline(HCI4D(scene_dir, cache=True), cfg, seed=1,
                          device='cpu')
    assert {k: n for k, (_, n) in trace.totals().items()
            if k.startswith('mmlf.pipeline.')} == {
        'mmlf.pipeline.shift': 1, 'mmlf.pipeline.pack': 1}
    model = build_model(cfg)
    optimizer = loop.make_optimizer(model)
    batch = pipe.sample_batch(4)
    ranges = profiled(lambda: loop.train_step(cfg, model, optimizer,
                                              pipe.cache, batch, 0), tmp_path)
    count = {n: len(of(ranges, n)) for n in {r[0] for r in ranges}}
    assert count == {'mmlf.train.step': 1, 'mmlf.train.augment': 2,
                     'mmlf.train.forward': 2, 'mmlf.model.head': 2,
                     'mmlf.train.targets': 2, 'mmlf.train.loss': 2,
                     'mmlf.train.backward': 2, 'mmlf.train.optimizer': 1}
    step = of(ranges, 'mmlf.train.step')
    assert all(inside(r, step) for r in ranges)
    # the head, the targets and the loss inside each microbatch's forward
    forward = of(ranges, 'mmlf.train.forward')
    assert all(inside(r, forward) for name in ('mmlf.model.head',
                                               'mmlf.train.targets',
                                               'mmlf.train.loss')
               for r in of(ranges, name))
    # augment, forward (its head, targets and loss) and backward of each
    # microbatch, then Adam
    order = [r[0].split('.')[-1] for r in ranges if r[0] != 'mmlf.train.step']
    assert order == ['augment', 'forward', 'head', 'targets', 'loss',
                     'backward'] * 2 + ['optimizer']


def test_validation_spans(scene_dir, tmp_path):
    cfg = Config(**SMALL).finalize()
    model = init_live_(build_model(cfg), seed=2)
    out = str(tmp_path / 'run')
    os.makedirs(out)
    save_checkpoint_pt(os.path.join(out, 'checkpoint.pt'),
                       model.state_dict(), cfg)
    ranges = profiled(lambda: run_validation(
        out, scene_dir, val_ensamble=True, val_disp_step=0.5,
        device='cpu'), tmp_path)
    count = {n: len(of(ranges, n)) for n in {r[0] for r in ranges}}
    assert count == {'mmlf.val.load': 1, 'mmlf.data.load_scene': 1,
                     'mmlf.val.members': 1, 'mmlf.model.head': 14,
                     'mmlf.val.readback': 1, 'mmlf.val.calibration': 1,
                     'mmlf.val.save': 1}
    # each of the 14 members' forwards ends in the head
    assert all(inside(r, of(ranges, 'mmlf.val.members'))
               for r in of(ranges, 'mmlf.model.head'))
    # the scene is decoded once, to run it; the writer takes that sample
    assert inside(of(ranges, 'mmlf.data.load_scene')[0],
                  of(ranges, 'mmlf.val.load'))


def test_every_span_name_is_under_mmlf():
    calls, names = 0, set()
    for root, _, files in os.walk(PACKAGE):
        for f in files:
            if not f.endswith('.py') or \
                    os.path.join(root, f) == trace.__file__:
                continue
            with open(os.path.join(root, f)) as fh:
                text = fh.read()
            calls += len(re.findall(r'\bspan\(', text))
            names |= set(re.findall(r"\bspan\('(mmlf\.[a-z_.]+)'\)", text))
            assert len(re.findall(r"\bspan\('mmlf\.[a-z_.]+'\)", text)) == \
                len(re.findall(r'\bspan\(', text)), f
    assert names == NAMES and calls >= len(NAMES)
