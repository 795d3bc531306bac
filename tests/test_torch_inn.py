"""The port's INN (``--model_inn``) against ``mmlf_tpu.models.inn`` on the
same seeded inputs, weights carried across by ``utils/convert``: the
subnet, one coupling block (forward and reverse, every actnorm type, hard
and soft permutation), the whole net (forward, log-det, inverse, train-mode
BatchNorm statistics, ``--model_cross``, ``--bf16``), the IB loss and its
parameter gradients, then the slice: 3 steps of ``train()`` against JAX's
log rows, both validate CLIs (whole and ``--val_tile`` at the 108-pixel
window that meets ``mu``'s shape), export and serve.  Sizes: 1 + 1 blocks,
9 views, 32² crops and 64² / 128² synthetic scenes.  The JAX variables are
made input-sensitive first (``_live``): at flax's init the subnets'
0.035-scaled convs leave every coupling near the identity."""

import os
import shutil

import click
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import traverse_util

from mmlf_tpu.config import Config as JConfig
from mmlf_tpu.data.synth import generate_dataset
from mmlf_tpu.export import export_inference as j_export
from mmlf_tpu.export import load_exported as j_load_exported
from mmlf_tpu.losses import information_bottleneck as j_ib
from mmlf_tpu.models.inn import INN as JINN
from mmlf_tpu.models.inn import AIOCouplingBlock as JBlock
from mmlf_tpu.models.inn import Subnet as JSubnet
from mmlf_tpu.ops.codecs import reg_to_class as j_reg_to_class
from mmlf_tpu.serve import InferenceEngine as JEngine
from mmlf_tpu.train import checkpoint as jckpt
from mmlf_tpu.train import loop as jloop
from mmlf_tpu.validate.cli import run_validation as j_run_validation
from mmlf_tpu_torch.config import Config
from mmlf_tpu_torch.export import export_inference, load_exported
from mmlf_tpu_torch.losses import information_bottleneck
from mmlf_tpu_torch.models import build_model
from mmlf_tpu_torch.models.inn import INN, AIOCouplingBlock, Subnet
from mmlf_tpu_torch.ops.codecs import reg_to_class
from mmlf_tpu_torch.serve import InferenceEngine
from mmlf_tpu_torch.train import loop
from mmlf_tpu_torch.train.checkpoint import load_checkpoint
from mmlf_tpu_torch.utils.convert import (coupling_block_state,
                                          state_dict_from_jax)
from mmlf_tpu_torch.validate.cli import run_validation

import torch_threads  # noqa: F401  torch's share of the CPUs under xdist

SMALL = dict(model_views=9, model_in_blocks=1, model_out_blocks=1,
             model_inn=True)
METRICS = ('mse', 'badpix', 'kld', 'kld_mm', 'kld_um', 'nll')
# fp32 forward outputs: |port - JAX| <= RTOL·|JAX| + ATOL (distances reach
# ~200, so their absolute error is a few 1e-5)
RTOL, ATOL = 1e-5, 2e-5


def _stacks(seed, size=32, b=2, views=9):
    rng = np.random.default_rng(seed)
    return [rng.random((b, views, size, size, 3), dtype=np.float32)
            for _ in range(4)]


def _live(variables, seed):
    """JAX variables made input-sensitive, in numpy: subnet kernels at
    kaiming scale, random biases, actnorm offsets and BN affines, BN
    running statistics near identity; ``perm`` and ``mu`` as drawn."""
    rng = np.random.default_rng(seed)
    flat = traverse_util.flatten_dict(jax.device_get(dict(variables)))
    out = {}
    for path, x in flat.items():
        x = np.array(x, np.float32)
        leaf = path[-1]
        if leaf == 'kernel':
            x = x * (0.7 / 0.035)
        elif leaf == 'bias' or leaf == 'act_offset':
            x = rng.normal(size=x.shape).astype(np.float32) * 0.1
        elif leaf == 'scale':
            x = rng.uniform(0.75, 1.25, x.shape).astype(np.float32)
        elif leaf == 'act_scale':
            x = x + rng.normal(size=x.shape).astype(np.float32) * 0.1
        elif leaf == 'mean':
            x = rng.normal(size=x.shape).astype(np.float32) * 0.1
        elif leaf == 'var':
            x = rng.uniform(0.75, 1.25, x.shape).astype(np.float32)
        out[path] = x
    return traverse_util.unflatten_dict(out)


def _close(got, want, what, rtol=RTOL, atol=ATOL):
    got = got.detach().float().numpy() if torch.is_tensor(got) else got
    np.testing.assert_allclose(got, np.asarray(want, np.float32), rtol=rtol,
                               atol=atol, err_msg=what)


# --bf16 itself moves the zixels ~9e-3 (relative L2) from fp32 in either
# package at this size; the packages agree within 3.1e-3
BF16_REL = 5e-3


def _rel_l2(got, want) -> float:
    got = got.detach().float().numpy() if torch.is_tensor(got) else got
    want = np.asarray(want, np.float32)
    return float(np.linalg.norm(got - want) / max(np.linalg.norm(want),
                                                  1e-30))


def _nchw(x):
    return torch.from_numpy(np.ascontiguousarray(np.transpose(x,
                                                              (0, 3, 1, 2))))


# ------------------------------------------------------------------ modules


@pytest.mark.parametrize('train', [False, True], ids=['eval', 'train'])
def test_subnet_matches_jax(train):
    """Subnet forward and, in train mode, its BN running statistics
    (momentum 0.01: flax's default 0.99)."""
    x = np.random.default_rng(3).normal(size=(2, 12, 12, 5)).astype('f4')
    jm = JSubnet(8, 2)
    v = _live(jax.jit(jm.init)(jax.random.PRNGKey(0), jnp.asarray(x)), 1)
    if train:
        want, upd = jm.apply(v, jnp.asarray(x), True, mutable=['batch_stats'])
    else:
        want = jm.apply(v, jnp.asarray(x))
    m = Subnet(5, 8, 2)
    p, st = v['params'], v['batch_stats']['bn']
    sd = {f'{c}.weight': torch.from_numpy(np.ascontiguousarray(
        np.transpose(p[c]['kernel'], (3, 2, 0, 1)))) for c in ('conv1',
                                                                'conv2')}
    sd.update({f'{c}.bias': torch.from_numpy(p[c]['bias'])
               for c in ('conv1', 'conv2')})
    sd.update({'bn.weight': torch.from_numpy(p['bn']['scale']),
               'bn.bias': torch.from_numpy(p['bn']['bias']),
               'bn.running_mean': torch.from_numpy(st['mean']),
               'bn.running_var': torch.from_numpy(st['var']),
               'bn.num_batches_tracked': torch.tensor(0)})
    m.load_state_dict(sd, strict=True)
    m.train(train)
    got = m(_nchw(x))
    _close(got.permute(0, 2, 3, 1), want, 'subnet')
    if train:
        for key, ours in (('mean', m.bn.running_mean),
                          ('var', m.bn.running_var)):
            _close(ours, upd['batch_stats']['bn'][key], key, atol=1e-6)


@pytest.mark.parametrize('act', ['SOFTPLUS', 'SIGMOID', 'EXP'])
@pytest.mark.parametrize('soft', [False, True], ids=['hard', 'soft'])
def test_coupling_block_matches_jax(act, soft):
    """One coupling block, eval mode: forward output and log-det, then the
    reverse of the JAX forward's output."""
    c = 27
    x = np.random.default_rng(4).normal(size=(2, 10, 12, c)).astype('f4')
    jm = JBlock(c, act_norm_type=act, permute_soft=soft)
    v = _live(jax.jit(jm.init)(jax.random.PRNGKey(2), jnp.asarray(x)), 5)
    y, ld = jm.apply(v, jnp.asarray(x))
    xr, ldr = jm.apply(v, y, rev=True)
    m = AIOCouplingBlock(c, act_norm_type=act, permute_soft=soft)
    m.load_state_dict(coupling_block_state(v['params'], v['batch_stats']),
                      strict=True)
    m.eval()
    with torch.no_grad():
        got, got_ld = m(_nchw(x))
        back, back_ld = m(_nchw(np.asarray(y)), rev=True)
    _close(got.permute(0, 2, 3, 1), y, 'y')
    _close(got_ld, ld, 'logdet', rtol=1e-5, atol=1e-3)
    _close(back.permute(0, 2, 3, 1), xr, 'x (rev)', atol=1e-4)
    _close(back_ld, ldr, 'logdet (rev)', rtol=1e-5, atol=1e-3)
    np.testing.assert_allclose(back.permute(0, 2, 3, 1).numpy(), x,
                               atol=1e-4)
    assert float(torch.abs(got.permute(0, 2, 3, 1) - _nchw(x).permute(
        0, 2, 3, 1)).max()) > 0.1          # the block is not the identity


def _jax_inn(kw, stacks, seed=0):
    jcfg = JConfig(**SMALL, **kw).finalize()
    jm = JINN.from_config(jcfg)
    # jitted: flax's eager init takes ~10x longer on the CPU
    v = _live(jax.jit(jm.init)(jax.random.PRNGKey(seed),
                               *map(jnp.asarray, stacks)), seed + 1)
    cfg = Config(**SMALL, **kw).finalize()
    m = INN.from_config(cfg)
    m.load_state_dict(state_dict_from_jax(v, cfg), strict=True)
    return jm, v, m, cfg


INN_CASES = {'fp32': {}, 'cross': {'model_cross': True},
             'soft_sigmoid': {'model_soft_permutation': True,
                              'model_act_norm_type': 'SIGMOID'},
             'bf16': {'bf16': True}}


@pytest.mark.parametrize('case', list(INN_CASES))
def test_inn_matches_jax(case):
    """The whole net in eval mode (every output), the inverse of its
    zixels, and one train-mode forward's outputs and BN running statistics
    (momentum 0.01).  fp32 element-wise (``RTOL``/``ATOL``); ``--bf16``
    (eval mode only) rounds the subnet convs' operands and outputs, and a
    rounding that falls the other way in one package moves a few elements
    by a bf16 ulp, so its outputs are held in relative L2
    (``BF16_REL``)."""
    stacks = _stacks(6)
    jm, v, m, cfg = _jax_inn(INN_CASES[case], stacks)
    bf16 = case == 'bf16'
    j_in = list(map(jnp.asarray, stacks))
    t_in = list(map(torch.from_numpy, stacks))

    def check(got, want, what, rtol=RTOL, atol=ATOL):
        if bf16:
            assert _rel_l2(got, want) <= BF16_REL, what
        else:
            _close(got, want, what, rtol=rtol, atol=atol)

    # jitted (one compile costs less than flax's op-by-op dispatch here),
    # except in bf16: under jit XLA on the CPU keeps some bf16 ops'
    # intermediates in f32 (6.6e-3 from the port's train-mode zixels),
    # where flax's op-by-op run rounds where the module says
    jit = (lambda f: f) if bf16 else jax.jit
    want = jit(jm.apply)(v, *j_in)
    m.eval()
    with torch.no_grad():
        got = m(*t_in)
    assert got['jac'].shape == (2,) and got['mu'].shape == (1, m.dims,
                                                             m.dims)
    for k in ('zixels', 'jac', 'dists', 'nll', 'posterior'):
        check(got[k], want[k], k)
    # the log of a posterior variance: where the posterior is peaked the
    # variance is ~1e-2 and carries the distances' rounding relatively
    check(got['logvar'], want['logvar'], 'logvar', atol=1e-4)
    # mean is a bin centre; a pixel whose two nearest centres are within
    # rounding of each other may pick the other one
    agree = np.isclose(got['mean'].numpy(), np.asarray(want['mean']),
                       atol=1e-5)
    assert agree.mean() >= (0.98 if bf16 else 0.999)

    if not bf16:
        with torch.no_grad():
            back = m.inverse(got['zixels'])
        j_back = jax.jit(jm.inverse)(v, want['zixels'])
        for b, jb, s in zip(back, j_back, stacks):
            _close(b, jb, 'inverse', atol=1e-4)
            np.testing.assert_allclose(b.numpy(), s, atol=1e-4)

    if bf16:            # the rounding points are the eval forward's
        return
    want_t, upd = jit(lambda vv, *a: jm.apply(
        vv, *a, train=True, mutable=['batch_stats']))(v, *j_in)
    m.train()
    with torch.no_grad():
        got_t = m(*t_in)
    check(got_t['zixels'], want_t['zixels'], 'zixels (train)', rtol=1e-4,
          atol=1e-4)
    sd = state_dict_from_jax({'params': v['params'],
                              'batch_stats': upd['batch_stats']}, cfg)
    for k, t in m.state_dict().items():
        if 'running' in k:
            check(t, sd[k].numpy(), k, atol=1e-6)


def test_inn_input_sensitivity():
    """Zeroing one view stack moves the zixels: the comparisons above see
    the streams, not only the biases."""
    stacks = _stacks(7)
    _, _, m, _ = _jax_inn({}, stacks)
    m.eval()
    with torch.no_grad():
        base = m(*map(torch.from_numpy, stacks))['zixels']
        cut = m(*map(torch.from_numpy, stacks[:3] + [0 * stacks[3]]))
    assert float(torch.abs(cut['zixels'] - base).max()) > 0.1


def test_ib_loss_and_grads_match_jax():
    """The IB loss of a train-mode forward against reg_to_class targets
    (rel 1e-5), and every parameter's gradient within 2e-3 of the leaf's
    largest: every subnet ends in a train-mode BN, whose JAX backward
    loses digits in fp32 (ROADMAP Queue 3; the repo's BN step tests hold
    5e-3, this seed's worst leaf is 3.5e-4); the permutation's is zero."""
    stacks = _stacks(8)
    jm, v, m, cfg = _jax_inn({}, stacks)
    gt = np.random.default_rng(9).uniform(-3.5, 3.5, (2, 32, 32)).astype('f4')
    beta = 0.7

    def jloss(params):
        out, _ = jm.apply({'params': params,
                           'batch_stats': v['batch_stats']},
                          *map(jnp.asarray, stacks), train=True,
                          mutable=['batch_stats'])
        return j_ib(out, j_reg_to_class(jnp.asarray(gt), -3.5, 3.5,
                                        cfg.steps), beta)

    want, grads = jax.jit(jax.value_and_grad(jloss))(v['params'])
    m.train()
    out = m(*map(torch.from_numpy, stacks))
    loss = information_bottleneck(
        out, reg_to_class(torch.from_numpy(gt), -3.5, 3.5, cfg.steps), beta)
    loss.backward()
    assert float(loss.detach()) == pytest.approx(float(want), rel=1e-5)
    want_g = state_dict_from_jax({'params': jax.device_get(grads)}, cfg)
    assert 'perm' not in dict(m.named_parameters())
    # a subnet's conv2 bias feeds a train-mode BN, so its true gradient is
    # zero and both packages return rounding noise (JAX's up to 2.6e-6 of
    # the largest gradient: its BN backward cancels in fp32, ROADMAP Queue
    # 3): the floor is 1e-5 of the largest gradient of any leaf
    floor = 1e-5 * max(np.abs(want_g[k].numpy()).max()
                       for k, _ in m.named_parameters())
    for k, p in m.named_parameters():
        w = want_g[k].numpy()
        np.testing.assert_allclose(p.grad.numpy(), w, rtol=1e-4,
                                   atol=max(2e-3 * np.abs(w).max(), floor),
                                   err_msg=k)
    for k, b in m.named_buffers():
        if k.endswith('perm'):
            assert np.abs(want_g[k].numpy()).max() == 0.0


# ---------------------------------------------------------------- the slice


@pytest.fixture(scope='module')
def data_dirs(tmp_path_factory):
    root = tmp_path_factory.mktemp('torch_inn')
    dirs = [str(root / n) for n in ('train', 'val', 'val128')]
    generate_dataset(dirs[0], scenes=2, size=64, seed=0)
    generate_dataset(dirs[1], scenes=1, size=64, seed=7)
    generate_dataset(dirs[2], scenes=1, size=128, seed=5)
    return dirs


def _kw(data_dirs, **kw):
    return dict(SMALL, train_trainset=data_dirs[0],
                train_valset=data_dirs[1], train_bs=4, train_ps=32,
                train_lr=1e-3, train_max_downscale=1, val_interval=2,
                val_loss_margin=5, train_steps=3, **kw)


def _rows(path):
    lines = open(os.path.join(path, 'log.csv')).read().splitlines()
    assert lines[0] == loop.LOG_HEADER
    return [[float(v) for v in line.split(',')] for line in lines[1:]]


def _to_jax_run(state_dict, cfg, out_dir):
    """A JAX ``checkpoint.msgpack`` run directory holding the port's INN
    weights (the inverse of ``state_dict_from_jax``)."""
    params, stats = {}, {}
    for k, t in state_dict.items():
        a = t.numpy()
        parts = k.split('.')
        if k == 'mu':
            params['mu'] = a
            continue
        blk = f'{parts[0]}_{parts[1]}'
        rest = parts[2:]
        if rest[-1] == 'num_batches_tracked':
            continue
        if rest[0] in ('act_scale', 'act_offset', 'perm'):
            params.setdefault(blk, {})[rest[0]] = a
            continue
        sub, layer, leaf = rest
        if layer == 'bn':
            if leaf.startswith('running'):
                stats.setdefault(blk, {}).setdefault(sub, {}).setdefault(
                    'bn', {})[leaf[8:]] = a
                continue
            leaf = {'weight': 'scale', 'bias': 'bias'}[leaf]
        elif leaf == 'weight':
            leaf, a = 'kernel', np.transpose(a, (2, 3, 1, 0))
        params.setdefault(blk, {}).setdefault(sub, {}).setdefault(
            layer, {})[leaf] = a
    os.makedirs(out_dir, exist_ok=True)
    jckpt.save_checkpoint(out_dir, {'params': params, 'batch_stats': stats},
                          cfg.to_dict(), 0, 3, 0.0)
    return out_dir


@pytest.fixture(scope='module')
def inn_runs(data_dirs, tmp_path_factory):
    """3 steps of the JAX package's train() and of the port's, from the
    same initial variables: ``(jax run dir, port run dir)``."""
    root = tmp_path_factory.mktemp('inn_runs')
    kw = _kw(data_dirs)
    jcfg, cfg = JConfig(**kw).finalize(), Config(**kw).finalize()
    jout, tout = str(root / 'jax'), str(root / 'torch')
    os.makedirs(jout)
    os.makedirs(tout)
    jloop.train(jcfg, jout, progress=False)
    init = jax.jit(JINN.from_config(jcfg).init)(
        jax.random.PRNGKey(jcfg.train_seed),
        *[jnp.zeros((1, 9, 32, 32, 3))] * 4)
    state = loop.train(cfg, tout, progress=False, device='cpu',
                       initial_state=state_dict_from_jax(
                           jax.device_get(dict(init)), cfg))
    assert state.step == 3
    return jout, tout


def test_inn_train_slice_matches_jax(inn_runs):
    """The log rows (train loss, val IB loss, mse, badpix at steps 0-2)
    within rel 1e-3, as the UPR slice; the checkpoint keeps ``perm`` and
    the optimizer leaves it out."""
    jout, tout = inn_runs
    want, got = _rows(jout), _rows(tout)
    assert [r[0] for r in got] == [r[0] for r in want] == [0, 1, 2]
    np.testing.assert_allclose(np.array(got)[:, 1:5],
                               np.array(want)[:, 1:5], rtol=1e-3)
    ckpt = load_checkpoint(tout)
    assert ckpt['iteration'] == 3
    sd = ckpt['model_state_dict']
    assert 'in_net_hv.0.perm' in sd and 'mu' in sd
    model = build_model(Config.from_dict(ckpt['hyper_parameters']))
    model.load_state_dict(sd, strict=True)
    n_params = len(list(model.parameters()))
    assert len(ckpt['optimizer_state_dict']['param_groups'][0]['params']) \
        == n_params


@pytest.mark.parametrize('which', ['port', 'jax'])
def test_inn_validate_clis_match(inn_runs, data_dirs, tmp_path, which):
    """Both validate CLIs on one checkpoint: the port's run (its weights
    written to a JAX ``checkpoint.msgpack`` for the JAX CLI) and the JAX
    run (read by both).  Metrics rel 1e-3 (the JAX ``kld`` is off float64
    by ~1e-4, ROADMAP Queue 3); result.pfm and posterior.npy 5e-4."""
    from mmlf_tpu.utils import pfm
    jout, tout = inn_runs
    jdir, tdir = str(tmp_path / 'jax'), str(tmp_path / 'torch')
    if which == 'port':
        sd = load_checkpoint(tout)['model_state_dict']
        cfg = Config.from_dict(load_checkpoint(tout)['hyper_parameters'])
        _to_jax_run(sd, cfg, jdir)
        shutil.copytree(tout, tdir)
    else:
        shutil.copytree(jout, jdir)
        shutil.copytree(jout, tdir)
    want = j_run_validation(jdir, data_dirs[1], val_loss_margin=5)
    got = run_validation(tdir, data_dirs[1], val_loss_margin=5,
                         device='cpu')
    for k in METRICS:
        assert np.isfinite(got[k]), k
        assert got[k] == pytest.approx(want[k], rel=1e-3, abs=1e-6), k
    sj, st = (os.path.join(d, 'scenes', 'scene_00') for d in (jdir, tdir))
    np.testing.assert_allclose(pfm.load(os.path.join(st, 'result.pfm')),
                               pfm.load(os.path.join(sj, 'result.pfm')),
                               atol=5e-4)
    np.testing.assert_allclose(np.load(os.path.join(st, 'posterior.npy')),
                               np.load(os.path.join(sj, 'posterior.npy')),
                               atol=5e-4)
    assert np.load(os.path.join(st, 'posterior.npy')).shape[0] == 108


def test_inn_usage_rules_match_jax(inn_runs, data_dirs):
    """--model_discrete is a usage error for an INN checkpoint in both
    CLIs.  --val_ensamble is one in the port; the JAX CLI checks only the
    stored ``val_ensamble`` and then fails in its scene program with a
    TypeError (ROADMAP Queue 3).  The train loop refuses
    --train_accum_exact for the INN, as the JAX step does."""
    jout, _ = inn_runs
    with pytest.raises(click.UsageError, match='INN'):
        j_run_validation(jout, data_dirs[1], model_discrete=True)
    with pytest.raises(TypeError):
        j_run_validation(jout, data_dirs[1], val_ensamble=True)
    for kw in ({'val_ensamble': True}, {'model_discrete': True}):
        with pytest.raises(click.UsageError, match='INN'):
            run_validation(jout, data_dirs[1], device='cpu', **kw)
    cfg = Config(**_kw(data_dirs, train_accum=2,
                       train_accum_exact=True)).finalize()
    with pytest.raises(ValueError, match='INN'):
        loop.check_accum(cfg)


def test_inn_val_tile_108_window_matches_jax(inn_runs, data_dirs, tmp_path):
    """``--val_tile 100`` at halo 4 makes the window 108, ``mu``'s side:
    both packages' two-window probe keeps ``mu`` out of the stitched
    outputs.  The stitched mean equals the whole-scene run's (tiling is
    exact for the INN) and the metrics JAX's on its own tiled run."""
    from mmlf_tpu.utils import pfm
    jout, _ = inn_runs
    dirs = {n: str(tmp_path / n) for n in ('jax', 'torch', 'whole')}
    for d in dirs.values():
        shutil.copytree(jout, d)
    want = j_run_validation(dirs['jax'], data_dirs[2], val_loss_margin=5,
                            val_tile=100)
    got = run_validation(dirs['torch'], data_dirs[2], val_loss_margin=5,
                         val_tile=100, device='cpu')
    whole = run_validation(dirs['whole'], data_dirs[2], val_loss_margin=5,
                           device='cpu')
    for k in METRICS:
        assert got[k] == pytest.approx(want[k], rel=1e-3, abs=1e-6), k
        assert got[k] == pytest.approx(whole[k], rel=1e-4, abs=1e-6), k
    res = [pfm.load(os.path.join(d, 'scenes', 'scene_00', 'result.pfm'))
           for d in (dirs['torch'], dirs['whole'], dirs['jax'])]
    np.testing.assert_allclose(res[0], res[1], atol=1e-5)
    np.testing.assert_allclose(res[0], res[2], atol=5e-4)


def test_inn_tiled_forward_probe_matches_jax():
    """At the 108 window (tile 100, halo 4) ``mu`` has the window's shape:
    one probe takes it for spatial; the two-window probe drops it and
    ``jac`` to None, as the JAX package's ``_probe_spatial_dims`` does,
    and stitches the rest, equal to the whole scene's forward (1e-5; the
    JAX package's tiled run is held in the CLI test above)."""
    from mmlf_tpu.validate.tiling import _probe_spatial_dims as j_probe
    from mmlf_tpu_torch.validate.tiling import tiled_forward
    stacks = _stacks(11, size=128, b=1)
    jm, v, m, _ = _jax_inn({}, stacks)
    m.eval()
    t_in = list(map(torch.from_numpy, stacks))
    got = tiled_forward(m, t_in, 100, 4, probe=True)
    _, want = j_probe(lambda vv, *a: jm.apply(vv, *a), v,
                      tuple(map(jnp.asarray, stacks)), 108)
    one_probe = tiled_forward(m, t_in, 100, 4)
    assert one_probe['mu'] is not None         # the coincidence is real
    with torch.no_grad():
        whole = m(*t_in)
    for k in ('mu', 'jac', 'scores'):
        assert got[k] is None and want[k] is None, k
    for k in ('mean', 'logvar', 'posterior', 'zixels'):
        assert want[k] is not None, k
        _close(got[k], whole[k], k, rtol=1e-5, atol=1e-5)


def test_inn_export_and_serve_match_jax(inn_runs, data_dirs):
    """The JAX-trained INN run: the port's fp32 and u8 artifacts against
    ``mmlf_tpu.export``'s (every shared output key, 5e-5 absolute:
    ``dists`` near 100), the refusals (ensemble, tiled), and the port's
    server against ``mmlf_tpu.serve``'s on a scene."""
    jout, _ = inn_runs
    fn, meta = load_exported(export_inference(jout, 64, 64), device='cpu')
    assert meta['config']['model_inn']
    jfn, _ = j_load_exported(j_export(jout, 64, 64, platforms=('cpu',)))
    stacks = _stacks(10, size=64, b=1)
    got = fn(*map(torch.from_numpy, stacks))
    want = jfn(*map(jnp.asarray, stacks))
    assert 'scores' not in got
    for k in ('mean', 'logvar', 'posterior', 'dists', 'jac'):
        _close(got[k], want[k], k, rtol=1e-5, atol=5e-5)
    u8 = [np.round(s * 255).astype(np.uint8) for s in stacks]
    fn8, _ = load_exported(export_inference(jout, 64, 64, u8=True),
                           device='cpu')
    jfn8, _ = j_load_exported(j_export(jout, 64, 64, u8=True,
                                       platforms=('cpu',)))
    got8 = fn8(*map(torch.from_numpy, u8), 0.0)
    want8 = jfn8(*map(jnp.asarray, u8), np.float32(0.0))
    _close(got8['mean'], want8['mean'], 'mean (u8)', atol=1e-5)
    for kw in ({'val_ensamble': True}, {'tiled': 16}):
        with pytest.raises(ValueError, match='INN'):
            j_export(jout, 64, 64, platforms=('cpu',), **kw)
        with pytest.raises(ValueError, match='INN'):
            export_inference(jout, 64, 64, **kw)

    scene = os.path.join(data_dirs[1], 'scene_00')
    got = InferenceEngine(jout, device='cpu').infer(scene)
    want = JEngine(jout).infer(scene)
    assert got['shape'] == want['shape'] == [64, 64]
    for k in ('mse', 'badpix_007'):
        assert got[k] == pytest.approx(want[k], rel=1e-3, abs=1e-6), k
