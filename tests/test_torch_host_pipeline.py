"""The port's host training pipeline against mmlf_tpu's: the host batch of
``TrainPipeline.sample_batch`` bit for bit (threads or not, static shift,
downscale factors, no augmentation, native code or not), the batched
augmentation of a host microbatch against the per-sample ``augment_batch``,
and 3 steps of ``train()`` on the host pipeline against the JAX package's
log rows: forced by ``--host_pipeline`` (plain, with ``--pallas_trunk`` and
with accumulation), and taken by itself for scenes of different shapes and
for a scene cache over the limit."""

import os
import shutil

import numpy as np
import pytest
import torch

from mmlf_tpu.config import Config as JConfig
from mmlf_tpu.data import HCI4D as JHCI4D
from mmlf_tpu.data.pipeline import TrainPipeline as JTrainPipeline
from mmlf_tpu.data.synth import generate_dataset
from mmlf_tpu.train import loop as jloop
from mmlf_tpu_torch import native
from mmlf_tpu_torch.config import Config
from mmlf_tpu_torch.data import pipeline as P
from mmlf_tpu_torch.data.hci4d import HCI4D
from mmlf_tpu_torch.train import loop
from mmlf_tpu_torch.utils.convert import state_dict_from_jax

import torch_threads  # noqa: F401  torch's share of the CPUs under xdist

# the batched augmentation against the per-sample chain: the i and d
# stacks shift rows then columns there, columns then rows here, so each
# value may differ by a few float32 roundings of values below ~2
AUG_ATOL = 2e-6


@pytest.fixture(scope='module')
def scenes_192(tmp_path_factory):
    """Two 192² scenes: windows of ps 16 fit at every downscale 1-4."""
    root = str(tmp_path_factory.mktemp('host_192'))
    generate_dataset(root, scenes=2, size=192, seed=1)
    return root


@pytest.fixture(scope='module')
def data_dirs(tmp_path_factory):
    root = tmp_path_factory.mktemp('host_train')
    train_dir, val_dir = str(root / 'train'), str(root / 'val')
    generate_dataset(train_dir, scenes=2, size=64, seed=0)
    generate_dataset(val_dir, scenes=1, size=64, seed=7)
    # one 64² and one 80² scene: the JAX package's switch to the host
    # pipeline for scenes of different shapes
    mixed = str(root / 'mixed')
    generate_dataset(mixed, scenes=1, size=64, seed=3)
    other = str(root / 'other')
    generate_dataset(other, scenes=1, size=80, seed=4)
    shutil.move(os.path.join(other, 'scene_00'),
                os.path.join(mixed, 'scene_01'))
    return train_dir, val_dir, mixed


def _pipelines(root, seed=3, **kw):
    jp = JTrainPipeline(JHCI4D(root, cache=True), JConfig(**kw).finalize(),
                        seed=seed)
    tp = P.TrainPipeline(HCI4D(root, cache=True), Config(**kw).finalize(),
                         seed=seed)
    return jp, tp


def _assert_batches_equal(got, want):
    for k in want._fields[:-1]:
        g, w = getattr(got, k), np.asarray(getattr(want, k))
        assert g.dtype == w.dtype and g.shape == w.shape, k
        np.testing.assert_array_equal(g, w, err_msg=k)
    for k in want.aug._fields:
        np.testing.assert_array_equal(getattr(got.aug, k),
                                      np.asarray(getattr(want.aug, k)),
                                      err_msg=f'aug.{k}')


@pytest.mark.parametrize('kw', [
    {'train_num_workers': 0}, {'train_num_workers': 4},
    {'train_shift': 1.5, 'train_num_workers': 4},
    {'train_shift': -2.25, 'train_num_workers': 0},
    {'train_max_downscale': 1}, {'train_max_downscale': 2},
    {'train_max_downscale': 3, 'train_num_workers': 0},
    {'train_max_downscale': 4},
    {'train_no_data_augment': True, 'train_max_downscale': 4}],
    ids=lambda kw: ','.join(f'{k[6:]}={v}' for k, v in kw.items()))
def test_sample_batch_matches_jax(scenes_192, kw):
    """Two consecutive batches of 8 windows: every field and every
    ``AugParams`` leaf bit for bit, so the generators advance alike."""
    jp, tp = _pipelines(scenes_192, train_ps=16, **kw)
    try:
        assert tp.max_f == jp.max_f
        for _ in range(2):
            _assert_batches_equal(tp.sample_batch(8), jp.sample_batch(8))
        got = tp.sample_batch(1)
        _assert_batches_equal(got, jp.sample_batch(1))
        assert got.h.shape == (1, 9, tp.win, tp.win, 3)
    finally:
        tp.close()
        jp.close()


def test_sample_batch_factors_cover_the_range(scenes_192):
    _, tp = _pipelines(scenes_192, train_ps=16, train_max_downscale=4)
    b = tp.sample_batch(64)
    # the gt window of a factor-f sample is the scene's at stride f over f
    assert np.all(np.isfinite(b.gt)) and b.mpi.shape[1] == P.MAX_PLANES
    tp.close()


def test_sample_batch_without_native_code(scenes_192, monkeypatch):
    """The numpy window cutter gives the batch the native one gives."""
    if native.get_lib() is None:
        pytest.skip('g++ is unavailable')
    kw = dict(train_ps=16, train_max_downscale=4)
    _, tp = _pipelines(scenes_192, **kw)
    want = tp.sample_batch(8)
    tp.close()
    monkeypatch.setenv(native.DISABLE_ENV, '1')
    native.reset()
    try:
        _, tp = _pipelines(scenes_192, **kw)
        _assert_batches_equal(tp.sample_batch(8), want)
        tp.close()
    finally:
        monkeypatch.delenv(native.DISABLE_ENV)
        native.reset()


@pytest.mark.parametrize('with_mpi', [False, True])
@pytest.mark.parametrize('kw', [{'train_shift': 1.5},
                                {'train_no_data_augment': True}])
def test_augment_host_batch_matches_augment_batch(scenes_192, with_mpi, kw):
    """The batched augmentation of a host microbatch against the per-sample
    chain, on a batch with every rotation."""
    _, tp = _pipelines(scenes_192, train_ps=16, train_max_downscale=4, **kw)
    batch = tp.sample_batch(16)
    tp.close()
    if not kw.get('train_no_data_augment'):
        assert set(batch.aug.rot_k.tolist()) == {0, 1, 2, 3}
    dev = P.batch_to_device(batch, 'cpu', with_mpi=True)
    want = P.augment_batch(dev, 16)
    got = P.augment_host_batch(
        dev if with_mpi else dev._replace(mpi=None), 16)
    b = len(batch.aug.shift)
    for j in range(4):
        w = want[j].permute(0, 1, 4, 2, 3).reshape(b, 27, 16, 16)
        torch.testing.assert_close(got[j], w, rtol=0, atol=AUG_ATOL)
    assert torch.equal(got[4], want[4])
    assert torch.equal(got[6], want[6]) and got[6].dtype == torch.int32
    if with_mpi:
        assert torch.equal(got[5], want[5])
    else:
        assert got[5] is None


def test_chunk_slice_of_a_host_batch(scenes_192):
    _, tp = _pipelines(scenes_192, train_ps=16)
    batch = tp.sample_batch(6)
    tp.close()
    part = P.chunk_slice(batch, 2, 4)
    assert type(part) is P.Batch
    np.testing.assert_array_equal(part.h, batch.h[2:4])
    np.testing.assert_array_equal(part.aug.color, batch.aug.color[2:4])


# ------------------------------------------------------- the slice as a whole


def _kw(data_dirs, train_dir=None, **kw):
    base = dict(train_trainset=train_dir or data_dirs[0],
                train_valset=data_dirs[1], train_bs=4, train_ps=32,
                train_lr=1e-3, train_max_downscale=1, val_interval=2,
                val_loss_margin=5, train_steps=3, model_chs=8,
                model_in_blocks=1, model_out_blocks=2, model_uncert=True)
    base.update(kw)
    return base


def _rows(path):
    lines = open(os.path.join(path, 'log.csv')).read().splitlines()
    assert lines[0] == loop.LOG_HEADER
    return [[float(v) for v in line.split(',')] for line in lines[1:]]


def _jax_init(jcfg, ps=32):
    import jax
    import jax.numpy as jnp
    from mmlf_tpu.models import FeedForward as JFeedForward
    model = JFeedForward.from_config(jcfg)
    variables = model.init(jax.random.PRNGKey(jcfg.train_seed),
                           *[jnp.zeros((1, jcfg.model_views, ps, ps, 3))] * 4)
    return jax.tree_util.tree_map(np.asarray, dict(variables))


def _host_slice(tmp_path, monkeypatch, jax_kw, torch_kw, expect_host=True):
    """JAX train() with ``jax_kw`` and the port's with ``torch_kw`` from the
    same initial variables; the port's run must take the host pipeline
    (``expect_host``), and the log rows agree."""
    kinds = []

    class Recording(P.TrainPipeline):
        def __init__(self, *a, **kw):
            kinds.append(type(self).__name__)
            super().__init__(*a, **kw)

    class RecordingDevice(P.DevicePipeline):
        def __init__(self, *a, **kw):
            kinds.append('DevicePipeline')
            super().__init__(*a, **kw)

    monkeypatch.setattr(loop, 'TrainPipeline', Recording)
    monkeypatch.setattr(loop, 'DevicePipeline', RecordingDevice)
    jcfg, cfg = JConfig(**jax_kw).finalize(), Config(**torch_kw).finalize()
    jout, tout = str(tmp_path / 'jax'), str(tmp_path / 'torch')
    os.makedirs(jout)
    os.makedirs(tout)
    jloop.train(jcfg, jout, progress=False)
    state = loop.train(cfg, tout, progress=False, device='cpu',
                       initial_state=state_dict_from_jax(_jax_init(jcfg),
                                                         cfg))
    assert state.step == 3
    assert kinds == (['Recording'] if expect_host else ['DevicePipeline'])
    want, got = _rows(jout), _rows(tout)
    assert [r[0] for r in got] == [r[0] for r in want] == [0, 1, 2]
    # as the device path's slice test: Adam's first steps are ~sign(g)·lr
    np.testing.assert_allclose(np.array(got)[:, 1:5],
                               np.array(want)[:, 1:5], rtol=1e-3)
    return tout


@pytest.mark.parametrize('extra', [
    {}, {'pallas_trunk': True}, {'train_accum': 2, 'train_shift': 1.0},
    {'cache_bf16': True}],
    ids=['plain', 'pallas_trunk', 'accum2_shift', 'cache_bf16'])
def test_host_pipeline_train_slice_matches_jax(data_dirs, tmp_path,
                                               monkeypatch, extra):
    """``--host_pipeline`` on both sides; ``--cache_bf16`` has no effect on
    the host path in either package."""
    kw = _kw(data_dirs, host_pipeline=True, **extra)
    _host_slice(tmp_path, monkeypatch, kw, kw)


def test_mixed_scene_shapes_take_the_host_pipeline(data_dirs, tmp_path,
                                                   monkeypatch):
    """A 64² and an 80² scene: both packages switch to the host pipeline by
    themselves (no flag), and the runs agree."""
    kw = _kw(data_dirs, train_dir=data_dirs[2])
    _host_slice(tmp_path, monkeypatch, kw, kw)


def test_cache_limit_takes_the_host_pipeline(data_dirs, tmp_path,
                                             monkeypatch):
    """The port's cache limit patched below the scenes' bytes switches it
    to the host pipeline, held against the JAX package's
    ``--host_pipeline``; under the limit the device cache stays."""
    monkeypatch.setattr(loop, 'DEVICE_CACHE_LIMIT', 1 << 20)
    kw = _kw(data_dirs)
    _host_slice(tmp_path, monkeypatch, dict(kw, host_pipeline=True), kw)


def test_under_the_cache_limit_the_device_cache_stays(data_dirs, tmp_path,
                                                      monkeypatch):
    kw = _kw(data_dirs)
    _host_slice(tmp_path, monkeypatch, kw, kw, expect_host=False)


def test_train_seeds_the_globals(data_dirs, tmp_path):
    """``train()`` pins the stdlib and numpy globals to the run's seed, as
    the JAX package does (the transforms library draws from them; the
    pipelines draw from their own generator, so after the run the globals
    are where the seed put them)."""
    import random
    random.seed(123)
    np.random.seed(123)
    loop.train(Config(**_kw(data_dirs, train_steps=1, train_seed=5,
                            host_pipeline=True)).finalize(), str(tmp_path),
               progress=False, device='cpu')
    got = random.random(), np.random.random()
    random.seed(5)
    np.random.seed(5)
    assert got == (random.random(), np.random.random())
