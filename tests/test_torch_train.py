"""The port's train step and loop against mmlf_tpu's: schedules and
targets, one step's loss / gradients / BatchNorm statistics from the same
variables on the same batch, Adam, BatchNorm momentum and variance, and the
slice as a whole (3 steps of train(), log rows, then ESE validate of the
port's checkpoint), plus resume, SIGTERM, the NaN guard and the profiler."""

import os
import signal
import threading
import time

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
from mmlf_tpu_torch.data.hci4d import HCI4D
from mmlf_tpu_torch.data.pipeline import DevicePipeline
from mmlf_tpu_torch.models.feed_forward import FeedForward, init_default_
from mmlf_tpu_torch.train import loop
from mmlf_tpu_torch.train.checkpoint import load_checkpoint, save_checkpoint
from mmlf_tpu_torch.utils.convert import state_dict_from_jax


@pytest.fixture(scope='module')
def data_dirs(tmp_path_factory):
    root = tmp_path_factory.mktemp('torch_train')
    train_dir, val_dir = str(root / 'train'), str(root / 'val')
    generate_dataset(train_dir, scenes=2, size=64, seed=0)
    generate_dataset(val_dir, scenes=1, size=64, seed=7)
    return train_dir, val_dir


@pytest.fixture(scope='module')
def step_root(tmp_path_factory):
    root = str(tmp_path_factory.mktemp('torch_step'))
    generate_dataset(root, scenes=1, size=128, seed=0)
    return root


def _kw(data_dirs, **kw):
    train_dir, val_dir = data_dirs
    base = dict(train_trainset=train_dir, train_valset=val_dir,
                train_bs=4, train_ps=32, train_lr=1e-3,
                train_max_downscale=1, val_interval=2, val_loss_margin=5,
                train_steps=3, model_chs=8, model_in_blocks=1,
                model_out_blocks=2)
    base.update(kw)
    return base


def _jax_init(jcfg, ps=32):
    """The JAX package's initial variables for ``jcfg`` (numpy leaves)."""
    model = JFeedForward.from_config(jcfg)
    variables = model.init(jax.random.PRNGKey(jcfg.train_seed),
                           *[jnp.zeros((1, jcfg.model_views, ps, ps, 3))] * 4)
    return jax.tree_util.tree_map(np.asarray, dict(variables))


# --------------------------------------------------------------- schedules


@pytest.mark.parametrize('kw', [{}, {'train_warm_start': True},
                                {'train_cooling': 300},
                                {'train_warm_start': True,
                                 'train_cooling': 700}])
def test_lr_schedule_matches_jax(kw):
    cfg = Config(train_lr=1e-3, **kw).finalize()
    jcfg = JConfig(train_lr=1e-3, **kw).finalize()
    for step in (0, 1, 7, 299, 300, 301, 999, 1000, 1001, 2500):
        want = float(jloop.lr_schedule(jcfg, jnp.int32(step)))
        assert loop.lr_schedule(cfg, step) == want, step


@pytest.mark.parametrize('kw', [
    {}, {'train_loss_strongest': True}, {'model_discrete': True},
    {'model_discrete': True, 'train_loss_multimodal': True},
    {'train_loss_padding': 0.8},
    {'train_loss_padding': 0.8, 'train_loss_multimodal': True}])
def test_prepare_targets_matches_jax(kw):
    rng = np.random.default_rng(1)
    b, k, p = 2, 3, 24
    gt = rng.uniform(-2, 2, (b, p, p)).astype(np.float32)
    mpi = rng.random((b, k, p, p, 5), dtype=np.float32)
    mpi[..., 4] = rng.uniform(-2, 2, (b, k, p, p))
    mask = (rng.random((b, p, p)) > 0.2).astype(np.int32)
    want = jloop.prepare_targets(JConfig(**kw).finalize(), jnp.asarray(gt),
                                 jnp.asarray(mpi), jnp.asarray(mask))
    got = loop.prepare_targets(Config(**kw).finalize(), torch.from_numpy(gt),
                               torch.from_numpy(mpi), torch.from_numpy(mask))
    for name, w, g in zip(('gt', 'mpi', 'gt_classes', 'mask',
                           'mask_padding'), want, got):
        if w is None:
            assert g is None, name
            continue
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-6,
                                   atol=0, err_msg=name)


# -------------------------------------------------------------- one step


def _capture_grads():
    """An optax transform that stores the gradients in its state and
    leaves the parameters as they are."""
    def init(params):
        return {'g': jax.tree_util.tree_map(jnp.zeros_like, params)}

    def update(updates, state, params=None):
        return jax.tree_util.tree_map(jnp.zeros_like, updates), {'g': updates}

    return optax.GradientTransformation(init, update)


STEP_CASES = {
    'upr': dict(model_uncert=True),
    'upr_accum2': dict(model_uncert=True, train_accum=2),
    'upr_accum2_exact': dict(model_uncert=True, train_accum=2,
                             train_accum_exact=True),
    'base': dict(),
    'base_accum2': dict(train_accum=2),
    'base_accum2_exact': dict(train_accum=2, train_accum_exact=True),
    'dpp': dict(model_discrete=True),
    'dpp_accum2': dict(model_discrete=True, train_accum=2),
    'upr_multimodal': dict(model_uncert=True, train_loss_multimodal=True),
    'upr_multimodal_accum2': dict(model_uncert=True,
                                  train_loss_multimodal=True, train_accum=2),
    'upr_eval_mode': dict(model_uncert=True, train_accum=2),
}
NO_BN_CASES = {
    'upr': dict(model_uncert=True),
    'upr_accum2_exact': dict(model_uncert=True, train_accum=2,
                             train_accum_exact=True),
    'base_accum2_exact': dict(train_accum=2, train_accum_exact=True),
    'dpp': dict(model_discrete=True),
    'upr_multimodal_accum2': dict(model_uncert=True,
                                  train_loss_multimodal=True, train_accum=2),
}
CASES = [(name, False) for name in STEP_CASES] + \
    [(name, True) for name in NO_BN_CASES]

# Gradient tolerance relative to each leaf's max.  Without BatchNorm the
# two packages compute the same fp32 arithmetic in another order: 1e-6.
# The JAX package's train-mode BatchNorm takes the variance as
# E[x²] − E[x]² and dγ as rstd·(Σdy·x − mean·Σdy), both of which lose
# digits to cancellation in fp32; against a float64 evaluation its
# gradients are ~1e-5 off where the port's are ~1e-7
# (test_batchnorm_gradient_accuracy), and the gap reaches ~3e-3 of the
# leaf max in the first layers of the net: 5e-3.
GRAD_ATOL = {False: 5e-3, True: 1e-6}


@pytest.mark.parametrize('case,no_bn', CASES,
                         ids=[f'{n}{"_nobn" if nb else ""}'
                              for n, nb in CASES])
def test_train_step_matches_jax(step_root, case, no_bn):
    """Loss, every parameter gradient and the updated BN statistics of one
    step (the JAX package's jitted step with a gradient-capturing
    transform) from the same variables on the same batch."""
    kw = dict(train_trainset=step_root, train_bs=4, train_ps=32,
              train_lr=1e-2, train_max_downscale=2, model_chs=6,
              model_in_blocks=1, model_out_blocks=2,
              model_batchnorm_momentum=0.3, model_no_batchnorm=no_bn,
              **(NO_BN_CASES if no_bn else STEP_CASES)[case])
    bn_train = case != 'upr_eval_mode'
    jcfg, cfg = JConfig(**kw).finalize(), Config(**kw).finalize()

    jpipe = JDevicePipeline(JHCI4D(step_root, cache=True), jcfg, seed=4)
    batch = jpipe.sample_batch(4)
    jmodel = JFeedForward.from_config(jcfg)
    tx = _capture_grads()
    state = jloop.init_state(jcfg, jmodel, tx,
                             [jnp.zeros((1, 9, 32, 32, 3))] * 4)
    variables = {'params': jax.device_get(state.params),
                 'batch_stats': jax.device_get(state.batch_stats)}
    step = jloop.make_train_step(jcfg, jmodel, tx, bn_train=bn_train,
                                 use_cache=True)
    new_state, jloss = step(state, batch, jpipe.cache)
    jgrads = state_dict_from_jax(
        {'params': jax.device_get(new_state.opt_state['g']),
         'batch_stats': jax.device_get(new_state.batch_stats)}, cfg)

    tpipe = DevicePipeline(HCI4D(step_root, cache=True), cfg, seed=4,
                           device='cpu')
    model = FeedForward.from_config(cfg)
    model.load_state_dict(state_dict_from_jax(variables, cfg), strict=True)
    optimizer = torch.optim.SGD(model.parameters(), lr=0.0)
    loss = loop.train_step(cfg, model, optimizer, tpipe.cache,
                           tpipe.sample_batch(4), 0, bn_train=bn_train)

    np.testing.assert_allclose(float(loss), float(jloss), rtol=1e-5)
    g_max = max(float(np.abs(g.numpy()).max()) for g in jgrads.values())
    for name, p in model.named_parameters():
        want = jgrads[name].numpy()
        if bn_train and not no_bn and name.endswith('.2.bias') and \
                name.replace('.2.bias', '.3.weight') in jgrads:
            # a conv bias feeding a train-mode BN: its gradient is zero,
            # both sides hold rounding noise
            assert np.abs(p.grad.numpy()).max() < 1e-5 * g_max, name
            assert np.abs(want).max() < 1e-5 * g_max, name
            continue
        np.testing.assert_allclose(
            p.grad.numpy(), want, rtol=1e-4,
            atol=GRAD_ATOL[no_bn] * max(np.abs(want).max(), 1e-12),
            err_msg=name)
    buffers = dict(model.named_buffers())
    for name, want in jgrads.items():
        if name.endswith(('running_mean', 'running_var')):
            # rtol 1e-5 of the leaf's max: a channel mean near zero is a
            # sum of terms that each carry the earlier layers' rounding
            want = want.numpy()
            np.testing.assert_allclose(buffers[name].numpy(), want,
                                       rtol=1e-5,
                                       atol=1e-5 * np.abs(want).max(),
                                       err_msg=name)


def test_batchnorm_gradient_accuracy():
    """The port's train-mode BatchNorm gradients against a float64
    evaluation, beside the JAX package's FusedBatchNorm (inputs with a
    mean larger than their spread, as conv outputs of images have)."""
    from mmlf_tpu.ops.batchnorm import FusedBatchNorm
    from mmlf_tpu_torch.ops.batchnorm import BatchNorm2d

    rng = np.random.default_rng(0)
    x = (rng.normal(size=(4, 9, 9, 6)) * 0.3 + 1.0).astype(np.float32)
    dy = rng.normal(size=x.shape).astype(np.float32)

    def port(dtype):
        bn = BatchNorm2d(6).to(dtype).train()
        xt = torch.from_numpy(x).permute(0, 3, 1, 2).to(dtype)
        xt.requires_grad_()
        y = bn(xt)
        (y * torch.from_numpy(dy).permute(0, 3, 1, 2).to(dtype)).sum() \
            .backward()
        return (xt.grad.permute(0, 2, 3, 1).double().numpy(),
                bn.weight.grad.double().numpy())

    jbn = FusedBatchNorm(momentum=0.9)
    jv = jbn.init(jax.random.PRNGKey(0), jnp.asarray(x),
                  use_running_average=False)

    def jf(xx, p):
        y, _ = jbn.apply({'params': p, 'batch_stats': jv['batch_stats']}, xx,
                         use_running_average=False, mutable=['batch_stats'])
        return jnp.sum(y * dy)

    jdx, jdp = jax.grad(jf, argnums=(0, 1))(jnp.asarray(x), jv['params'])
    (dx64, dw64), (dx32, dw32) = port(torch.float64), port(torch.float32)
    scale = np.abs(dx64).max()
    assert np.abs(dx32 - dx64).max() < 1e-6 * scale
    assert np.abs(dw32 - dw64).max() < 1e-6 * np.abs(dw64).max()
    # the JAX package's fused form is ~100x further from float64
    assert np.abs(np.asarray(jdx) - dx64).max() < 2e-5 * scale
    assert np.abs(np.asarray(jdp['scale']) - dw64).max() < 2e-5 * \
        np.abs(dw64).max() * 100


def test_adam_matches_optax():
    """torch.optim.Adam with the LR written into the param group equals
    optax.scale_by_adam followed by ``-lr·u`` over three steps."""
    rng = np.random.default_rng(0)
    p0 = rng.normal(size=(5, 7)).astype(np.float32)
    grads = [rng.normal(size=(5, 7)).astype(np.float32) * s
             for s in (1.0, 1e-3, 10.0)]
    lrs = [1e-3, 2e-3, 5e-4]

    tx = optax.scale_by_adam()
    params = jnp.asarray(p0)
    opt = tx.init(params)
    p = torch.nn.Parameter(torch.from_numpy(p0.copy()))
    torch_opt = loop.make_optimizer(torch.nn.ParameterList([p]))
    for g, lr in zip(grads, lrs):
        u, opt = tx.update(jnp.asarray(g), opt, params)
        params = params - lr * u
        p.grad = torch.from_numpy(g)
        torch_opt.param_groups[0]['lr'] = lr
        torch_opt.step()
    np.testing.assert_allclose(p.detach().numpy(), np.asarray(params),
                               rtol=1e-6, atol=1e-7)


def test_batchnorm_momentum_and_biased_variance():
    """One train-mode forward at model_batchnorm_momentum 0.3 updates the
    running statistics as the JAX package does: ra = 0.7·ra + 0.3·batch,
    with the biased batch variance."""
    kw = dict(model_chs=6, model_views=3, model_in_blocks=1,
              model_out_blocks=2, model_uncert=True,
              model_batchnorm_momentum=0.3)
    cfg, jcfg = Config(**kw).finalize(), JConfig(**kw).finalize()
    jmodel = JFeedForward.from_config(jcfg)
    rng = np.random.default_rng(0)
    stacks = [rng.random((2, 3, 12, 12, 3), dtype=np.float32)
              for _ in range(4)]
    variables = jax.tree_util.tree_map(np.asarray, dict(jmodel.init(
        jax.random.PRNGKey(1), *[jnp.asarray(s) for s in stacks])))
    # non-trivial running statistics to start from
    variables['batch_stats'] = jax.tree_util.tree_map(
        lambda a: (rng.random(a.shape) + 0.5).astype(np.float32),
        variables['batch_stats'])
    out, mutated = jmodel.apply(variables, *[jnp.asarray(s) for s in stacks],
                                train=True, mutable=['batch_stats'])
    want = state_dict_from_jax({'params': variables['params'],
                                'batch_stats': jax.device_get(
                                    mutated['batch_stats'])}, cfg)

    model = FeedForward.from_config(cfg)
    model.load_state_dict(state_dict_from_jax(variables, cfg), strict=True)
    got = model.train()(*[torch.from_numpy(s) for s in stacks])
    sd = model.state_dict()
    n_bn = 0
    for name in want:
        if name.endswith(('running_mean', 'running_var')):
            w = want[name].numpy()
            np.testing.assert_allclose(sd[name].numpy(), w, rtol=1e-5,
                                       atol=1e-5 * np.abs(w).max(),
                                       err_msg=name)
            n_bn += 1
    assert n_bn == 3 * 2            # 3 BN layers, 2 running buffers each
    for key in ('mean', 'logvar'):
        np.testing.assert_allclose(got[key].detach().numpy(),
                                   np.asarray(out[key]), atol=5e-5,
                                   err_msg=key)


def test_init_default_distributions():
    """flax's distributions: lecun-normal conv kernels (truncated at two
    standard deviations, variance 1/fan_in), zero biases, BN 1/0 and
    running statistics 0/1; the same seed gives the same weights."""
    cfg = Config(model_uncert=True, model_chs=16, model_in_blocks=1,
                 model_out_blocks=2).finalize()
    model = init_default_(FeedForward.from_config(cfg), seed=3)
    again = init_default_(FeedForward.from_config(cfg), seed=3)
    for (name, a), b in zip(model.state_dict().items(),
                            again.state_dict().values()):
        assert torch.equal(a, b), name
    w = model.out_net[0][0].weight.detach()         # (64, 64, 2, 2)
    fan_in = w[0].numel()
    assert abs(float(w.std()) * fan_in ** 0.5 - 1.0) < 0.05
    assert float(w.abs().max()) <= 2.0 / 0.8796256 / fan_in ** 0.5
    assert float(model.out_net[0][0].bias.abs().max()) == 0.0
    bn = model.out_net[0][3]
    assert torch.equal(bn.weight, torch.ones_like(bn.weight))
    assert torch.equal(bn.running_var, torch.ones_like(bn.running_var))
    assert float(bn.bias.abs().max() + bn.running_mean.abs().max()) == 0.0


def test_accum_exact_guards():
    """The JAX package's guards (mmlf_tpu/train/loop.py): padding and the
    INN raise; the multimodal uncertainty loss raises with a logvar anchor
    and passes without one."""
    base = dict(train_accum=2, train_accum_exact=True, model_uncert=True)
    with pytest.raises(ValueError, match='train_loss_padding'):
        loop.check_accum(Config(**base, train_loss_padding=3.5).finalize())
    with pytest.raises(ValueError, match='INN'):
        loop.check_accum(Config(train_accum=2, train_accum_exact=True,
                                model_inn=True).finalize())
    with pytest.raises(ValueError, match='multimodal'):
        loop.check_accum(Config(**base, train_loss_multimodal=True,
                                train_logvar_anchor=0.5).finalize())
    loop.check_accum(Config(**base, train_loss_multimodal=True).finalize())
    loop.check_accum(Config(**base).finalize())


# Each case once paired a ported flag with --model_inn, which raised.  The
# INN is ported: an INN case now trains one step from the JAX package's
# initial variables, and its log row (train loss, val IB loss, mse, badpix
# at step 0) is held against JAX's train() with the flags the JAX package
# acts on for an INN (INN_JAX_RUN: it ignores --pallas_trunk, --model_unet
# and --remat, and its --mesh_data step is its single-device step, tests/
# test_parallel.py).  --model_invertible still raises.
INN_JAX_RUNS = {'plain': {}, 'host': {'host_pipeline': True},
                'host_bf16': {'host_pipeline': True, 'bf16': True}}


def INN_JAX_RUN(kw):
    if kw.get('bf16'):
        return 'host_bf16'
    return 'host' if kw.get('host_pipeline') else 'plain'


@pytest.fixture(scope='module')
def inn_jax_rows(data_dirs, tmp_path_factory):
    """JAX's step-0 row and initial variables for each of INN_JAX_RUNS."""
    from mmlf_tpu.models.inn import INN as JINN
    out = {}
    for name, extra in INN_JAX_RUNS.items():
        kw = _kw(data_dirs, model_inn=True, model_out_blocks=1,
                 train_steps=1, **extra)
        jcfg = JConfig(**kw).finalize()
        jout = str(tmp_path_factory.mktemp(f'inn_{name}'))
        jloop.train(jcfg, jout, progress=False)
        init = jax.jit(JINN.from_config(jcfg).init)(
            jax.random.PRNGKey(jcfg.train_seed),
            *[jnp.zeros((1, 9, 32, 32, 3))] * 4)
        out[name] = (_rows(jout)[0], jax.device_get(dict(init)))
    return out


# the --mesh_data cases but one train in one run of two gloo ranks
# (``inn_mesh_rows``); ``{'mesh_data': 2, 'model_inn': True}`` starts its
# ranks through ``train()`` itself
INN_MESH_SHARED = ({'remat': True, 'mesh_data': 2, 'model_inn': True},
                   {'host_pipeline': True, 'mesh_data': 2, 'model_inn': True},
                   {'model_unet': True, 'mesh_data': 2, 'model_inn': True})


@pytest.fixture(scope='module')
def inn_mesh_rows(data_dirs, inn_jax_rows, tmp_path_factory):
    """The step-0 row of each INN_MESH_SHARED case, trained by two gloo
    ranks (``tests/torch_parallel_ranks.train_cases``) from the JAX
    package's initial variables."""
    import json
    import torch_parallel_ranks
    from mmlf_tpu_torch.parallel import mesh
    case_dir = str(tmp_path_factory.mktemp('inn_mesh'))
    cases = {}
    for j, kw in enumerate(INN_MESH_SHARED):
        full = _kw(data_dirs, model_out_blocks=1, train_steps=1, **kw)
        cfg = Config(**full).finalize()
        init = inn_jax_rows[INN_JAX_RUN(kw)][1]
        np.savez(os.path.join(case_dir, f'case{j}.npz'),
                 **{k: v.numpy() for k, v in
                    state_dict_from_jax(init, cfg).items()})
        out = os.path.join(case_dir, f'out{j}')
        os.makedirs(out)
        cases[f'case{j}'] = {'kw': full, 'out': out}
    with open(os.path.join(case_dir, 'train_cases.json'), 'w') as fh:
        json.dump(cases, fh)
    reports = mesh.launch(torch_parallel_ranks.train_cases, 2, (case_dir,),
                          device_type='cpu', timeout=240, store=case_dir)
    assert reports == [len(cases)] * 2
    return [_rows(c['out'])[0] for c in cases.values()]


@pytest.mark.parametrize('kw,match', [
    ({'pallas_trunk': True, 'model_unet': True, 'model_inn': True},
     'item 7'),
    ({'bf16': True, 'host_pipeline': True, 'model_inn': True}, 'item 7'),
    ({'cache_bf16': True, 'host_pipeline': True, 'model_inn': True},
     'item 7'),
    ({'remat': True, 'mesh_data': 2, 'model_inn': True}, 'item 7'),
    ({'host_pipeline': True, 'mesh_data': 2, 'model_inn': True}, 'ROADMAP'),
    ({'mesh_data': 2, 'model_inn': True}, 'ROADMAP'),
    ({'model_unet': True, 'mesh_data': 2, 'model_inn': True}, 'ROADMAP'),
    ({'model_inn': True}, 'ROADMAP'),
    ({'model_invertible': True}, 'INNs are not supported')])
def test_unported_flags_raise(tmp_path, kw, match, request):
    """--model_invertible raises; every --model_inn case trains (two gloo
    ranks under --mesh_data 2) and its step-0 row agrees with JAX's within
    rel 1e-3 (bf16: 2e-2)."""
    if not kw.get('model_inn'):
        with pytest.raises(NotImplementedError, match=match):
            loop.train(Config(**kw).finalize(), str(tmp_path), device='cpu')
        return
    data_dirs = request.getfixturevalue('data_dirs')
    want, init = request.getfixturevalue('inn_jax_rows')[INN_JAX_RUN(kw)]
    if kw in INN_MESH_SHARED:
        got = request.getfixturevalue('inn_mesh_rows')[
            INN_MESH_SHARED.index(kw)]
    else:
        cfg = Config(**_kw(data_dirs, model_out_blocks=1, train_steps=1,
                           **kw)).finalize()
        state = loop.train(cfg, str(tmp_path), progress=False, device='cpu',
                           initial_state=state_dict_from_jax(init, cfg))
        assert state.step == 1
        assert type(state.model).__name__ == 'INN'
        assert (state.ranks is not None) == (kw.get('mesh_data') == 2)
        got = _rows(str(tmp_path))[0]
    assert got[0] == want[0] == 0
    np.testing.assert_allclose(got[1:5], want[1:5],
                               rtol=2e-2 if kw.get('bf16') else 1e-3)


# ------------------------------------------------------- the slice as a whole


def _rows(path):
    lines = open(os.path.join(path, 'log.csv')).read().splitlines()
    assert lines[0] == loop.LOG_HEADER
    return [[float(v) for v in line.split(',')] for line in lines[1:]]


def test_train_slice_matches_jax_then_validates(data_dirs, tmp_path):
    """JAX train() and the port's train() from the same initial variables,
    3 UPR steps with augmentation and validation at steps 0 and 2: the log
    rows agree; then the port's validate CLI runs ESE on the port's
    checkpoint."""
    _slice_matches_jax_then_validates(data_dirs, tmp_path)


def test_trunk_train_slice_matches_jax_then_validates(data_dirs, tmp_path):
    """The same with ``--pallas_trunk`` on both sides: the JAX package's
    Pallas trunk (interpret mode) against the port's K3 trunk (its plain
    versions on the CPU); ESE validate of the checkpoint, which stores
    ``pallas_trunk``, takes the plain eval path."""
    _slice_matches_jax_then_validates(data_dirs, tmp_path, pallas_trunk=True)


def _slice_matches_jax_then_validates(data_dirs, tmp_path, **extra):
    from click.testing import CliRunner
    from mmlf_tpu_torch.validate.cli import main as validate_main

    kw = _kw(data_dirs, model_uncert=True, **extra)
    jcfg, cfg = JConfig(**kw).finalize(), Config(**kw).finalize()
    jout, tout = str(tmp_path / 'jax'), str(tmp_path / 'torch')
    os.makedirs(jout)
    os.makedirs(tout)
    jloop.train(jcfg, jout, progress=False)
    state = loop.train(cfg, tout, progress=False, device='cpu',
                       initial_state=state_dict_from_jax(_jax_init(jcfg),
                                                         cfg))
    assert state.step == 3

    want, got = _rows(jout), _rows(tout)
    assert [r[0] for r in got] == [r[0] for r in want] == [0, 1, 2]
    # Adam's first steps are ~sign(g)·lr, which lifts fp32 gradient
    # rounding into parameter differences of up to 2·lr
    np.testing.assert_allclose(np.array(got)[:, 1:5],
                               np.array(want)[:, 1:5], rtol=1e-3)
    assert got[0][5] > 1e9                       # unix-time quirk

    ckpt = load_checkpoint(tout)
    assert ckpt['iteration'] == 3 and ckpt['epoch'] == 0
    assert ckpt['hyper_parameters'] == cfg.to_dict()
    assert ckpt['optimizer_state_dict']['state'][0]['step'] == 3
    # the rolling checkpoint, written on the saver's thread, equals a
    # synchronous save of the final state
    sync = str(tmp_path / 'sync')
    os.makedirs(sync)
    save_checkpoint(sync, state.model, state.optimizer, cfg, ckpt['epoch'],
                    ckpt['iteration'], ckpt['loss'])
    _assert_same_payload(ckpt, load_checkpoint(sync))
    assert os.path.exists(os.path.join(tout, 'ours', 'disp_maps'))

    val_dir = data_dirs[1]
    res = CliRunner().invoke(validate_main, [tout, val_dir, '--val_ensamble',
                                             '--device', 'cpu'])
    assert res.exit_code == 0, res.output
    scene = os.path.join(tout, 'scenes', 'scene_00')
    for f in ('result.pfm', 'uncert.pfm', 'gmm.npy', 'posterior.npy'):
        assert os.path.exists(os.path.join(scene, f)), f
    assert np.load(os.path.join(scene, 'gmm.npy')).shape == (2, 70, 64, 64)


def _assert_same_payload(got, want, path='payload'):
    """Equal nested checkpoint payloads: tensors bit for bit."""
    if torch.is_tensor(want):
        assert torch.equal(got, want), path
    elif isinstance(want, dict):
        assert got.keys() == want.keys(), path
        for k in want:
            _assert_same_payload(got[k], want[k], f'{path}.{k}')
    elif isinstance(want, (list, tuple)):
        assert len(got) == len(want), path
        for j, (g, w) in enumerate(zip(got, want)):
            _assert_same_payload(g, w, f'{path}[{j}]')
    else:
        assert got == want, path


def test_resume_continues_with_mixed_seed(data_dirs, tmp_path, monkeypatch):
    seen = []

    class Recording(DevicePipeline):
        def __init__(self, *a, **kw):
            seen.append(kw.get('seed'))
            super().__init__(*a, **kw)

    monkeypatch.setattr(loop, 'DevicePipeline', Recording)
    out = str(tmp_path)
    loop.train(Config(**_kw(data_dirs, train_seed=11)).finalize(), out,
               progress=False, device='cpu')
    state = loop.train(Config(**_kw(data_dirs, train_seed=11, train_steps=5,
                                    train_resume=True)).finalize(), out,
                       progress=False, device='cpu')
    assert state.step == 5
    assert [int(r[0]) for r in _rows(out)] == [0, 1, 2, 3, 4]
    assert seen[0] == 11
    assert seen[1] == int(np.random.SeedSequence([11, 3]).generate_state(1)[0])
    assert load_checkpoint(out)['iteration'] == 5


def test_sigterm_writes_checkpoint(data_dirs, tmp_path):
    out = str(tmp_path)
    cfg = Config(**_kw(data_dirs, train_steps=100000,
                       val_interval=1000000)).finalize()
    log = os.path.join(out, 'log.csv')
    stop = threading.Event()

    def fire():
        # wait for the first log row (the handler is installed by then)
        deadline = time.time() + 120
        while time.time() < deadline and not stop.is_set():
            if os.path.exists(log) and \
                    len(open(log).read().splitlines()) >= 2:
                break
            time.sleep(0.02)
        if not stop.is_set() and \
                signal.getsignal(signal.SIGTERM) is not signal.SIG_DFL:
            signal.raise_signal(signal.SIGTERM)

    t = threading.Thread(target=fire)
    t.start()
    try:
        state = loop.train(cfg, out, progress=False, device='cpu')
    finally:
        stop.set()
        t.join(timeout=60)
    assert not t.is_alive()
    n = load_checkpoint(out)['iteration']
    assert 1 <= n < 100000 and state.step == n
    assert signal.getsignal(signal.SIGTERM) == signal.SIG_DFL


def test_nan_guard_fails_before_checkpoint(data_dirs, tmp_path, monkeypatch):
    orig = loop.train_step

    def poisoned(*a, **kw):
        return orig(*a, **kw) * float('nan')

    monkeypatch.setattr(loop, 'train_step', poisoned)
    cfg = Config(**_kw(data_dirs, train_nan_guard=True)).finalize()
    with pytest.raises(FloatingPointError, match='step 0'):
        loop.train(cfg, str(tmp_path), progress=False, device='cpu')
    assert not os.path.exists(os.path.join(str(tmp_path), 'checkpoint.pt'))


def test_profiler_trace_written(data_dirs, tmp_path):
    cfg = Config(**_kw(data_dirs, train_steps=12, val_interval=100,
                       train_profile=True)).finalize()
    loop.train(cfg, str(tmp_path), progress=False, device='cpu')
    assert os.path.getsize(os.path.join(str(tmp_path), 'profile',
                                        'trace.json')) > 0
