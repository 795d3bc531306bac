"""The port's data parallel (``--mesh_data``) against the JAX package's:
two gloo ranks on the CPU, each in its own process that imports only torch
and the port (``tests/torch_parallel_ranks.py``), meeting through a file
store under ``tmp_path``, each run joined under a timeout.  The JAX oracle
runs here, on the 8 host devices tests/conftest.py forces: its single-device
step equals its mesh step (tests/test_parallel.py), so the two ranks must
give the single-device step's loss, gradients and BatchNorm statistics.
Inputs and weights go to the ranks through files."""

import json
import os
import tempfile

import numpy as np
import jax
import jax.numpy as jnp
import optax
import pytest
import torch

from mmlf_tpu.config import Config as JConfig
from mmlf_tpu.data import HCI4D as JHCI4D
from mmlf_tpu.data.pipeline import DevicePipeline as JDevicePipeline
from mmlf_tpu.data.synth import generate_dataset
from mmlf_tpu.models import FeedForward as JFeedForward
from mmlf_tpu.train import loop as jloop
from mmlf_tpu_torch.config import Config
from mmlf_tpu_torch.parallel import mesh
from mmlf_tpu_torch.train import loop
from mmlf_tpu_torch.train.cli import main as train_main
from mmlf_tpu_torch.utils.convert import state_dict_from_jax

import torch_parallel_ranks
import torch_threads  # noqa: F401  torch's share of the CPUs under xdist

RANKS = 2
TIMEOUT_S = 120     # each run of the ranks; a hung run fails, never hangs
# tests/test_parallel.py's sizes
STEP_KW = dict(train_bs=8, train_ps=32, train_lr=1e-2, train_max_downscale=1,
               model_chs=6, model_in_blocks=1, model_out_blocks=2,
               model_uncert=True)
STEP_CASES = {'nobn': dict(model_no_batchnorm=True),
              'bn': dict(model_batchnorm_momentum=0.3),
              'bn_trunk': dict(model_batchnorm_momentum=0.3,
                               pallas_trunk=True)}


@pytest.fixture(scope='module')
def data_dirs(tmp_path_factory):
    root = tmp_path_factory.mktemp('torch_par')
    train_dir, val_dir = str(root / 'train'), str(root / 'val')
    generate_dataset(train_dir, scenes=2, size=64, seed=0)
    generate_dataset(val_dir, scenes=1, size=64, seed=3)
    return train_dir, val_dir


@pytest.fixture
def rank_tmp(tmp_path, monkeypatch):
    """Ranks started by ``loop.train`` meet under ``tmp_path`` too."""
    monkeypatch.setattr(tempfile, 'tempdir', str(tmp_path))
    return tmp_path


def _capture_grads():
    """An optax transform that keeps the gradients in its state and leaves
    the parameters as they are."""
    def init(params):
        return {'g': jax.tree_util.tree_map(jnp.zeros_like, params)}

    def update(updates, state, params=None):
        return jax.tree_util.tree_map(jnp.zeros_like, updates), {'g': updates}

    return optax.GradientTransformation(init, update)


@pytest.fixture(scope='module')
def step_results(data_dirs, tmp_path_factory):
    """Every case of STEP_CASES: the JAX single-device step here, and one
    step of the two ranks from the same variables on the same global
    batch (one run of the ranks for all cases)."""
    case_dir = str(tmp_path_factory.mktemp('par_steps'))
    root = data_dirs[0]
    cases, want = {}, {}
    for name, extra in STEP_CASES.items():
        kw = dict(STEP_KW, **extra)
        jcfg, cfg = JConfig(**kw).finalize(), Config(**kw).finalize()
        jpipe = JDevicePipeline(JHCI4D(root, cache=True), jcfg, seed=4)
        jmodel = JFeedForward.from_config(jcfg)
        tx = _capture_grads()
        state = jloop.init_state(jcfg, jmodel, tx,
                                 [jnp.zeros((1, 9, 32, 32, 3))] * 4)
        variables = {'params': jax.device_get(state.params),
                     'batch_stats': jax.device_get(state.batch_stats)}
        step = jloop.make_train_step(jcfg, jmodel, tx, use_cache=True)
        new_state, jloss = step(state, jpipe.sample_batch(jcfg.train_bs),
                                jpipe.cache)
        grads = state_dict_from_jax(
            {'params': jax.device_get(new_state.opt_state['g']),
             'batch_stats': jax.device_get(new_state.batch_stats)}, cfg)
        want[name] = (float(jloss), {k: v.numpy() for k, v in grads.items()})
        np.savez(os.path.join(case_dir, f'{name}.npz'),
                 **{k: v.numpy() for k, v in
                    state_dict_from_jax(variables, cfg).items()})
        cases[name] = {'kw': kw, 'root': root, 'seed': 4}
    with open(os.path.join(case_dir, 'cases.json'), 'w') as fh:
        json.dump(cases, fh)
    reports = mesh.launch(torch_parallel_ranks.step_cases, RANKS,
                          (case_dir,), device_type='cpu', timeout=TIMEOUT_S,
                          store=case_dir)
    assert reports == [len(cases)] * RANKS
    got = {}
    for name in cases:
        with np.load(os.path.join(case_dir, f'{name}.out.npz')) as z:
            got[name] = {k: z[k] for k in z}
    return want, got


@pytest.mark.parametrize('case', list(STEP_CASES))
def test_ranks_step_matches_jax_single_device(step_results, case):
    """Loss, every gradient and the updated BN statistics of the two ranks'
    step against the JAX single-device step.  Without BN: loss rel 1e-5,
    gradients atol 1e-5 / rtol 1e-4 (tests/test_parallel.py's).  With BN
    (plain and through K3's plain versions): gradients within 5e-3 of each
    leaf's max (the JAX package's BN gradients lose digits to cancellation,
    tests/test_torch_train.py), statistics within 1e-4 of themselves and
    of their leaf's max."""
    want, got = step_results
    jloss, jgrads = want[case]
    out = got[case]
    np.testing.assert_allclose(float(out['loss']), jloss, rtol=1e-5)
    no_bn = 'model_no_batchnorm' in STEP_CASES[case]
    g_max = max(float(np.abs(g).max()) for g in jgrads.values())
    n_grads = 0
    for key, g in out.items():
        if not key.startswith('grad/'):
            continue
        name, w = key[5:], jgrads[key[5:]]
        n_grads += 1
        if no_bn:
            np.testing.assert_allclose(g, w, atol=1e-5, rtol=1e-4,
                                       err_msg=name)
        elif name.endswith('.2.bias') and \
                name.replace('.2.bias', '.3.weight') in jgrads:
            # a conv bias feeding a train-mode BN: zero, rounding noise
            assert np.abs(g).max() < 1e-5 * g_max, name
        else:
            np.testing.assert_allclose(
                g, w, rtol=1e-4, atol=5e-3 * max(np.abs(w).max(), 1e-12),
                err_msg=name)
    assert n_grads == len([k for k in jgrads if k.endswith(('weight',
                                                              'bias'))])
    n_stats = 0
    for key, b in out.items():
        if key.endswith(('running_mean', 'running_var')):
            w = jgrads[key[7:]]
            np.testing.assert_allclose(b, w, rtol=1e-4,
                                       atol=1e-4 * np.abs(w).max(),
                                       err_msg=key)
            n_stats += 1
    assert n_stats == (0 if no_bn else 3 * 2)


def _rows(path):
    lines = open(os.path.join(path, 'log.csv')).read().splitlines()
    assert lines[0] == loop.LOG_HEADER
    return [[float(v) for v in line.split(',')] for line in lines[1:]]


def _slice_kw(data_dirs, **kw):
    train_dir, val_dir = data_dirs
    base = dict(train_trainset=train_dir, train_valset=val_dir,
                train_bs=4, train_ps=32, train_lr=1e-3,
                train_max_downscale=1, val_interval=1, val_loss_margin=5,
                train_steps=2, model_chs=6, model_in_blocks=1,
                model_out_blocks=2, model_uncert=True, mesh_data=RANKS)
    base.update(kw)
    return base


def test_mesh_data_train_matches_jax_mesh(data_dirs, rank_tmp):
    """JAX ``train()`` with ``--mesh_data 2`` and the port's ``train()`` from
    the same initial variables with the flags the train CLI parses: two
    gloo ranks, 2 UPR steps with augmentation and validation at both; the
    log rows agree (rtol 1e-3: Adam's first steps are ~sign(g)·lr)."""
    kw = _slice_kw(data_dirs)
    jcfg = JConfig(**kw).finalize()
    args = [str(rank_tmp)] + [f'--{k}={v}' for k, v in kw.items()
                              if not isinstance(v, bool)] + \
        [f'--{k}' for k, v in kw.items() if v is True] + ['--device', 'cpu']
    params = train_main.make_context('train', args).params
    cfg = Config.from_dict({k: v for k, v in params.items()
                            if k not in ('output_dir', 'device')}).finalize()
    assert cfg.mesh_data == RANKS and cfg.train_bs == 4
    jout, tout = str(rank_tmp / 'jax'), str(rank_tmp / 'torch')
    os.makedirs(jout)
    os.makedirs(tout)
    jloop.train(jcfg, jout, progress=False)
    model = JFeedForward.from_config(jcfg)
    init = model.init(jax.random.PRNGKey(jcfg.train_seed),
                      *[jnp.zeros((1, 9, 32, 32, 3))] * 4)
    state = loop.train(cfg, tout, progress=False, device='cpu',
                       initial_state=state_dict_from_jax(
                           jax.tree_util.tree_map(np.asarray, dict(init)),
                           cfg))
    assert state.step == 2 and len(state.ranks) == RANKS
    assert [r['step'] for r in state.ranks] == [2, 2]
    want, got = _rows(jout), _rows(tout)
    assert [r[0] for r in got] == [r[0] for r in want] == [0, 1]
    np.testing.assert_allclose(np.array(got)[:, 1:5],
                               np.array(want)[:, 1:5], rtol=1e-3)


def test_mesh_data_cli_trains_on_two_ranks(data_dirs, rank_tmp):
    """``python -m mmlf_tpu_torch.train.cli OUT --mesh_data 2 --device cpu``
    starts its two ranks and trains the global batch: rank 0's log and
    checkpoint, and rows equal to the same command on one device (rtol
    1e-3).  No other rank writes."""
    from click.testing import CliRunner
    kw = _slice_kw(data_dirs, model_batchnorm_momentum=0.3)
    outs = {}
    for n in (RANKS, 1):
        out = str(rank_tmp / f'cli{n}')
        os.makedirs(out)
        args = [out] + [f'--{k}={v}' for k, v in kw.items()
                        if not isinstance(v, bool) and k != 'mesh_data'] + \
            ['--model_uncert', '--mesh_data', str(n), '--device', 'cpu']
        res = CliRunner().invoke(train_main, args)
        assert res.exit_code == 0, res.output
        outs[n] = out
    want, got = _rows(outs[1]), _rows(outs[RANKS])
    assert [r[0] for r in got] == [0, 1]
    np.testing.assert_allclose(np.array(got)[:, 1:5],
                               np.array(want)[:, 1:5], rtol=1e-3)
    assert sorted(os.listdir(outs[RANKS])) == sorted(os.listdir(outs[1]))
    assert torch.load(os.path.join(outs[RANKS], 'checkpoint.pt'),
                      weights_only=False)['iteration'] == 2


def test_loud_single_device_fallback(data_dirs, rank_tmp, capfd,
                                     monkeypatch):
    """The JAX package's warning and a single-device run: on the CPU when
    the batch does not divide over N; on CUDA also when N exceeds the
    visible GPUs (checked without a card by ``data_parallel_size``)."""
    cfg = Config(**_slice_kw(data_dirs, train_bs=3, train_steps=1)).finalize()
    out = str(rank_tmp / 'fallback')
    os.makedirs(out)
    state = loop.train(cfg, out, progress=False, device='cpu')
    assert state.step == 1 and state.ranks is None
    err = capfd.readouterr().err
    assert ('WARNING: data-parallel mesh disabled (batch size 3 does not '
            'divide over 2 devices); training single-device') in err

    cuda = torch.device('cuda')
    monkeypatch.setattr(torch.cuda, 'device_count', lambda: 1)
    assert loop.data_parallel_size(Config(mesh_data=2, train_bs=4)
                                   .finalize(), cuda) == 1
    assert 'mesh size 2 exceeds the 1 local device(s)' in \
        capfd.readouterr().err
    monkeypatch.setattr(torch.cuda, 'device_count', lambda: 2)
    assert loop.data_parallel_size(Config(mesh_data=0, train_bs=4)
                                   .finalize(), cuda) == 2
    assert loop.data_parallel_size(Config(mesh_data=2, train_bs=8,
                                          train_accum=4).finalize(),
                                   cuda) == 2
    assert loop.data_parallel_size(Config(mesh_data=2, train_bs=12,
                                          train_accum=4).finalize(),
                                   cuda) == 1
    assert 'microbatch size 3 does not divide over 2 devices' in \
        capfd.readouterr().err
    assert loop.data_parallel_size(Config(mesh_data=0).finalize(),
                                   torch.device('cpu')) == 1


@pytest.mark.parametrize('n,accum,rank', [(8, 1, 0), (8, 1, 1), (8, 2, 1),
                                          (12, 3, 0)])
def test_shard_batch_splits_each_microbatch(n, accum, rank):
    """A rank's part of each microbatch is that microbatch's contiguous
    share, in order, and the ranks' parts cover the batch once."""
    size, piece = n // accum, n // accum // RANKS
    idx = mesh.shard_indices(n, accum, rank, RANKS)
    assert idx.tolist() == [c * size + rank * piece + j for c in range(accum)
                            for j in range(piece)]
    both = np.concatenate([mesh.shard_indices(n, accum, r, RANKS)
                           for r in range(RANKS)])
    assert sorted(both.tolist()) == list(range(n))
    with pytest.raises(ValueError, match='split'):
        mesh.shard_indices(6, 2, 0, RANKS)


def test_launch_reports_a_failed_rank(tmp_path):
    """A rank that raises stops the run, and its traceback comes back."""
    with pytest.raises(RuntimeError, match=r'rank \d failed'):
        mesh.launch(os.path.join, RANKS, (1, 2), timeout=TIMEOUT_S,
                    store=str(tmp_path))
