"""The port's training input pipeline against mmlf_tpu's: the same seed
gives the identical DeviceBatch, the packed pyramid is the same, the window
gather (kernel K1's plain version) is bit-identical to the Pallas kernel in
interpret mode and to the XLA gather, and the batched augmentation equals
the JAX package's fused path and its per-sample chain."""

import numpy as np
import jax
import pytest
import torch

from mmlf_tpu.config import Config as JConfig
from mmlf_tpu.data import HCI4D as JHCI4D
from mmlf_tpu.data import pipeline as JP
from mmlf_tpu.data.synth import generate_dataset
from mmlf_tpu.ops.pallas.window_gather import (pallas_window_gather,
                                               xla_window_gather)
from mmlf_tpu_torch.config import Config
from mmlf_tpu_torch.data import pipeline as P
from mmlf_tpu_torch.data.hci4d import HCI4D
from mmlf_tpu_torch.ops.kernels.window_gather import window_gather

import torch_threads  # noqa: F401  torch's share of the CPUs under xdist

PS = 32
# fp32 rounding of a lerp, a 3-term colour mix and a mean, taken in
# another order than the JAX package's matmul formulation
ATOL = 1e-5


@pytest.fixture(scope='module')
def root(tmp_path_factory):
    path = str(tmp_path_factory.mktemp('torch_pipe'))
    generate_dataset(path, scenes=2, size=128, seed=0)
    return path


def _pipes(root, seed=11, **kw):
    kw = dict(dict(train_ps=PS, train_max_downscale=2, train_shift=0.5), **kw)
    jpipe = JP.DevicePipeline(JHCI4D(root, cache=True),
                              JConfig(**kw).finalize(), seed=seed)
    tpipe = P.DevicePipeline(HCI4D(root, cache=True), Config(**kw).finalize(),
                             seed=seed, device='cpu')
    return jpipe, tpipe


@pytest.fixture(scope='module')
def pipes(root):
    return _pipes(root)


def _np(x):
    return x.numpy() if torch.is_tensor(x) else np.asarray(x)


@pytest.mark.parametrize('kw', [{}, {'train_accum': 2},
                                {'train_no_data_augment': True}])
def test_same_seed_same_device_batch(root, kw):
    jpipe, tpipe = _pipes(root, seed=5, **kw)
    for bs in (8, 6):
        jb, tb = jpipe.sample_batch(bs), tpipe.sample_batch(bs)
        jl, tl = jax.tree_util.tree_leaves(jb), jax.tree_util.tree_leaves(tb)
        assert len(jl) == len(tl) == 11
        for a, b in zip(jl, tl):
            a = np.asarray(a)
            assert a.dtype == b.dtype and a.shape == b.shape
            np.testing.assert_array_equal(a, b)


def test_device_cache_levels_equal(pipes):
    jpipe, tpipe = pipes
    assert jpipe.max_f == tpipe.max_f == 2 and tpipe.win == jpipe.win
    for field in ('img', 'aux', 'mpi'):
        for a, b in zip(getattr(jpipe.cache, field),
                        getattr(tpipe.cache, field)):
            np.testing.assert_array_equal(np.asarray(a), b.numpy(),
                                          err_msg=field)


@pytest.mark.parametrize('with_mpi', [True, False])
def test_window_gather_bit_identical(pipes, with_mpi):
    jpipe, tpipe = pipes
    db = tpipe.sample_batch(8)
    level = db.factor - 1
    assert set(level.tolist()) == {0, 1}      # every level of the pyramid
    c = jpipe.cache
    args = (db.scene, level, db.ws_y, db.ws_x, tpipe.win)
    want_p = pallas_window_gather(c.img, c.aux, c.mpi, *args,
                                  with_mpi=with_mpi, interpret=True)
    want_x = xla_window_gather(c.img, c.aux, c.mpi, *args, with_mpi=with_mpi)
    got = window_gather(tpipe.cache.img, tpipe.cache.aux, tpipe.cache.mpi,
                        *args, with_mpi=with_mpi)
    for name, g, wp, wx in zip(('img', 'aux', 'mpi'), got, want_p, want_x):
        if not with_mpi and name == 'mpi':
            assert g is None
            continue
        np.testing.assert_array_equal(g.numpy(), np.asarray(wp),
                                      err_msg=f'{name} vs pallas')
        np.testing.assert_array_equal(g.numpy(), np.asarray(wx),
                                      err_msg=f'{name} vs xla')


def test_window_gather_rejects_bad_input(pipes):
    _, tpipe = pipes
    c = tpipe.cache
    one = np.zeros(1, np.int32)
    with pytest.raises(ValueError, match='leaves its level'):
        # level 1 of a 128² scene has 64 rows: a 64-row window at row 8
        window_gather(c.img, c.aux, c.mpi, one, one + 1, one + 8, one,
                      tpipe.win)
    with pytest.raises(ValueError, match='level out'):
        window_gather(c.img, c.aux, c.mpi, one, one + 2, one, one, tpipe.win)
    with pytest.raises(TypeError, match='float32'):
        window_gather(tuple(t.double() for t in c.img), c.aux, c.mpi, one,
                      one, one, one, tpipe.win)


def test_gather_windows_matches_jax(pipes):
    jpipe, tpipe = pipes
    db = tpipe.sample_batch(6)
    want = JP.gather_windows(jpipe.cache, db, jpipe.win)
    got = P.gather_windows(tpipe.cache, db, tpipe.win)
    for name in ('h', 'v', 'i', 'd', 'gt', 'mpi', 'mask'):
        a, b = np.asarray(getattr(want, name)), _np(getattr(got, name))
        assert a.dtype == b.dtype, name
        np.testing.assert_array_equal(b, a, err_msg=name)


def _fold(stack):
    """(B, n, P, P, 3) → the port's folded NCHW (B, n*3, P, P)."""
    b, n, p, q, c = stack.shape
    return np.transpose(stack, (0, 1, 4, 2, 3)).reshape(b, n * c, p, q)


@pytest.mark.parametrize('with_mpi', [True, False])
def test_gather_augment_every_rotation_and_sign(pipes, with_mpi):
    jpipe, tpipe = pipes
    db = tpipe.sample_batch(8)
    # the parity contract of the JAX fused path: first half even rot_k
    db = db._replace(aug=db.aug._replace(
        rot_k=np.array([0, 2, 0, 2, 1, 3, 1, 3], np.int32),
        shift=np.array([0.6, -0.6, -0.8, 0.3, 0.6, -0.6, -0.0, 0.9],
                       np.float32)))
    got = P.gather_augment(tpipe.cache, db, PS, tpipe.win, with_mpi=with_mpi)
    fused = JP.gather_augment(jpipe.cache, db, PS, jpipe.win,
                              with_mpi=with_mpi, parity=True, fold=True)
    legacy = JP.augment_batch(JP.gather_windows(jpipe.cache, db, jpipe.win),
                              PS)
    names = ('h', 'v', 'i', 'd', 'gt', 'mpi', 'mask')
    for k, name in enumerate(names):
        g = got[k]
        if name == 'mpi' and not with_mpi:
            assert g is None
            continue
        f, leg = np.asarray(fused[k]), np.asarray(legacy[k])
        if k < 4:
            f = np.transpose(f, (0, 3, 1, 2))
            leg = _fold(leg)
        assert g.shape == f.shape, name
        np.testing.assert_allclose(g.numpy(), f, atol=ATOL,
                                   err_msg=f'{name} vs fused')
        np.testing.assert_allclose(g.numpy(), leg, atol=ATOL,
                                   err_msg=f'{name} vs per-sample chain')
    assert got[6].dtype == torch.int32


def test_plain_chain_matches_jax(pipes):
    """The port's per-sample oracle (gather_windows + augment_batch) against
    the JAX package's, on a plain sampled batch."""
    jpipe, tpipe = pipes
    db = tpipe.sample_batch(4)
    got = P.augment_batch(P.gather_windows(tpipe.cache, db, tpipe.win), PS)
    want = JP.augment_batch(JP.gather_windows(jpipe.cache, db, jpipe.win),
                            PS)
    for name, g, w in zip(('h', 'v', 'i', 'd', 'gt', 'mpi', 'mask'), got,
                          want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=ATOL,
                                   err_msg=name)


def test_gather_augment_other_sizes(root):
    """A second configuration: ps 16, a large static shift, three levels
    clamped to what a 128² scene fits, augmentation on."""
    jpipe, tpipe = _pipes(root, seed=3, train_ps=16, train_shift=2.5,
                          train_max_downscale=3)
    db = tpipe.sample_batch(6)
    got = P.gather_augment(tpipe.cache, db, 16, tpipe.win)
    want = JP.augment_batch(JP.gather_windows(jpipe.cache, db, jpipe.win), 16)
    for k, name in enumerate(('h', 'v', 'i', 'd', 'gt', 'mpi', 'mask')):
        w = np.asarray(want[k])
        w = _fold(w) if k < 4 else w
        np.testing.assert_allclose(got[k].numpy(), w, atol=ATOL,
                                   err_msg=name)
