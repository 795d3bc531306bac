"""The port's U-Net output net (``mmlf_tpu_torch/models/unet.py``,
``FeedForward(model_unet)``) against mmlf_tpu's: the module and the whole
net in eval and train mode through ``state_dict_from_jax`` (fp32 and bf16),
one train-mode loss with its gradients and BatchNorm statistics, 3 steps
of ``train()`` against the JAX log rows, the port's checkpoint through both
validate CLIs, a JAX-trained ``checkpoint.msgpack`` through the port's
validate, export and serve against the JAX package's, and ``--val_tile``,
which both packages refuse for a U-Net.

Tolerances: float32 outputs within 1e-5 (eval) and 1e-4 (train mode) of
their largest magnitude; the U-Net's gradients within 5e-3 of each leaf's
largest magnitude (the BatchNorm rule of ROADMAP.md Queue 3), the whole
net's in relative L2 norm (GRAD_L2, see the step test); bf16 outputs as
``test_unet_bf16_matches_jax`` states; log rows and metrics within 1e-3
relative (tests/test_torch_train.py's and tests/test_torch_validate.py's
rules).  The train slice runs at the reference's default LR 1e-5: Adam's
first steps move every parameter by ~lr·sign(g), so over the U-Net's 31M
parameters the gradient differences above (relu' flips under BatchNorm)
become loss differences of ~2% by step 2 at LR 1e-3.
"""

import os
import shutil

import click
import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from mmlf_tpu.config import Config as JConfig
from mmlf_tpu.data.synth import generate_dataset
from mmlf_tpu.export import export_inference as j_export
from mmlf_tpu.export import load_exported as j_load_exported
from mmlf_tpu.models import FeedForward as JFeedForward
from mmlf_tpu.models.unet import UNet as JUNet
from mmlf_tpu.serve import InferenceEngine as JEngine
from mmlf_tpu.train import loop as jloop
from mmlf_tpu.utils.convert import torch_state_to_flax
from mmlf_tpu.validate.cli import run_validation as j_run_validation
from mmlf_tpu_torch.config import Config
from mmlf_tpu_torch.export import export_inference, load_exported
from mmlf_tpu_torch.models.feed_forward import FeedForward, init_live_
from mmlf_tpu_torch.models.unet import UNet
from mmlf_tpu_torch.serve import InferenceEngine
from mmlf_tpu_torch.train import loop
from mmlf_tpu_torch.train.checkpoint import load_checkpoint
from mmlf_tpu_torch.utils.convert import _unet_state, state_dict_from_jax
from mmlf_tpu_torch.validate.cli import run_validation

import torch_threads  # noqa: F401  torch's share of the CPUs under xdist

SMALL = dict(model_chs=6, model_views=3, model_in_blocks=1,
             model_out_blocks=2, model_uncert=True, model_unet=True)
METRICS = ('mse', 'badpix', 'kld', 'kld_mm', 'kld_um', 'nll')
EVAL_TOL, TRAIN_TOL, GRAD_TOL = 1e-5, 1e-4, 5e-3
GRAD_L2, BF16_UNET_TOL = 5e-2, 0.1


def _rel_err(got, want) -> float:
    got = got.detach().float().numpy() if torch.is_tensor(got) else got
    want = np.asarray(want, np.float32)
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))


def _variables(cfg, seed=1):
    """Input-sensitive variables of ``cfg``'s net (the port's ``init_live_``
    through the JAX package's converter of reference checkpoints), as the
    JAX tree and as the port's state dict (``state_dict_from_jax``)."""
    live = init_live_(FeedForward.from_config(cfg), seed=seed)
    variables = torch_state_to_flax(
        {k: v.numpy() for k, v in live.state_dict().items()},
        in_blocks=cfg.model_in_blocks, out_blocks=cfg.model_out_blocks,
        cross=cfg.model_cross, unet=True)
    sd = state_dict_from_jax(variables, cfg)
    for k, v in live.state_dict().items():
        if not k.endswith('num_batches_tracked'):
            assert torch.equal(sd[k], v), k      # the round trip is exact
    return variables, sd


def _stacks(seed=0, size=48, views=3):
    rng = np.random.default_rng(seed)
    return [rng.random((2, views, size, size, 3), dtype=np.float32)
            for _ in range(4)]


# ------------------------------------------------------------- the module


@pytest.mark.parametrize('train', [False, True], ids=['eval', 'train'])
@pytest.mark.parametrize('size', [32, 27], ids=['even', 'odd'])
def test_unet_module_matches_jax(train, size):
    """``UNet`` alone (depth 3, wf 3) against ``mmlf_tpu.models.unet.UNet``
    on NHWC inputs, with an odd size whose pools floor (27 → 13 → 6, back
    up to 24): the same output shape and values, and in train mode the same
    running statistics."""
    cin, ncls = 5, 2
    jm = JUNet(ncls, depth=3, wf=3)
    rng = np.random.default_rng(3)
    x = rng.standard_normal((2, size, size, cin)).astype(np.float32)
    var = jax.tree_util.tree_map(np.asarray, dict(jm.init(
        jax.random.PRNGKey(1), jnp.asarray(x))))
    # live BatchNorm statistics and affines
    var = jax.tree_util.tree_map(
        lambda a: a + np.float32(0.2) * np.abs(np.asarray(
            rng.standard_normal(a.shape), np.float32)), var)
    sd = {}
    _unet_state(var['params'], var['batch_stats'], sd, prefix='', depth=3)
    model = UNet(cin, ncls, depth=3, wf=3)
    model.load_state_dict(sd, strict=True)
    model.train(train)
    got = model(torch.from_numpy(x).permute(0, 3, 1, 2))
    if train:
        want, mut = jm.apply(var, jnp.asarray(x), train=True,
                             mutable=['batch_stats'])
        want_sd = {}
        _unet_state(var['params'], jax.device_get(mut['batch_stats']),
                    want_sd, prefix='', depth=3)
        for k, v in model.state_dict().items():
            if 'running' in k:
                assert _rel_err(v, want_sd[k]) <= TRAIN_TOL, k
    else:
        want = jm.apply(var, jnp.asarray(x))
    want = np.asarray(want).transpose(0, 3, 1, 2)
    assert tuple(got.shape) == want.shape
    if size == 27:
        assert want.shape[-1] == 24          # the pools floor odd sizes
    assert _rel_err(got, want) <= (TRAIN_TOL if train else EVAL_TOL)


# ------------------------------------------------------------- the net


@pytest.mark.parametrize('train', [False, True], ids=['eval', 'train'])
def test_feed_forward_unet_matches_jax(train):
    """``FeedForward(model_unet)`` at full U-Net width (depth 5, wf 6)
    against the JAX net from the same variables; the output reacts to its
    inputs (no dead-net oracle)."""
    cfg, jcfg = Config(**SMALL).finalize(), JConfig(**SMALL).finalize()
    variables, sd = _variables(cfg)
    stacks = _stacks()
    model = FeedForward.from_config(cfg)
    model.load_state_dict(sd, strict=True)
    model.train(train)
    jm = JFeedForward.from_config(jcfg)
    jin = [jnp.asarray(s) for s in stacks]
    if train:
        jout, _ = jm.apply(variables, *jin, train=True,
                           mutable=['batch_stats'])
    else:
        jout = jm.apply(variables, *jin)
    with torch.no_grad():
        out = model(*[torch.from_numpy(s) for s in stacks])
        z = [torch.from_numpy(s) for s in stacks]
        z[0] = torch.zeros_like(z[0])
        out_z = model(*z)
    # the posterior exponentiates the logvar's differences: held in eval
    # mode, where they are small; mean and logvar hold it in train mode
    for key in ('mean', 'logvar') + (() if train else ('posterior',)):
        assert out[key].shape == jout[key].shape, key
        assert _rel_err(out[key], jout[key]) <= (
            TRAIN_TOL if train else EVAL_TOL), key
    assert float((out_z['mean'] - out['mean']).abs().max()) > 1e-3
    assert isinstance(model.out_net, UNet)
    assert 'out_net.up_path.3.conv_block.block.5.running_var' in sd


def _port_step(cfg, sd, stacks):
    model = FeedForward.from_config(cfg)
    model.load_state_dict(sd, strict=True)
    model.train()
    out = model(*[torch.from_numpy(s) for s in stacks])
    loss = out['mean'].abs().mean() + 0.1 * out['logvar'].mean()
    loss.backward()
    return model, float(loss.detach()), out


def _jax_step(jcfg, variables, stacks):
    jmodel = JFeedForward.from_config(jcfg)

    def jloss(params, stats):
        out, mut = jmodel.apply({'params': params, 'batch_stats': stats},
                                *[jnp.asarray(s) for s in stacks],
                                train=True, mutable=['batch_stats'])
        return (jnp.mean(jnp.abs(out['mean']))
                + 0.1 * jnp.mean(out['logvar'])), (out, mut['batch_stats'])

    (loss, (out, stats)), grads = jax.value_and_grad(jloss, has_aux=True)(
        variables['params'], variables['batch_stats'])
    return float(loss), out, state_dict_from_jax(
        {'params': jax.device_get(grads),
         'batch_stats': jax.device_get(stats)}, jcfg)


def _l2_err(got, want) -> float:
    return float(np.linalg.norm(got - want) / np.linalg.norm(want))


def test_unet_step_loss_grads_and_stats_match_jax():
    """One train-mode loss of the whole net: the loss, the BatchNorm
    running statistics and every gradient leaf.  Every U-Net BatchNorm
    follows a ReLU, and its backward subtracts the batch means of the
    cotangents, so a leaf's gradient is a small difference of large sums:
    a relu' that flips on a pre-activation within rounding of zero moves
    it by a few percent of its max, in any fp32 evaluation (the port's own
    fp32 gradients differ from its float64 ones by up to 6% of a leaf's
    max here, the JAX package's by up to 17%).  So the leaves are held in
    relative L2 norm (GRAD_L2), the port's fp32 leaves against its float64
    ones too; the 5e-3-of-max rule holds on the U-Net alone
    (``test_unet_module_grads_match_jax``)."""
    cfg, jcfg = Config(**SMALL).finalize(), JConfig(**SMALL).finalize()
    variables, sd = _variables(cfg)
    stacks = _stacks(1)
    jl, _, want = _jax_step(jcfg, variables, stacks)
    model, loss, _ = _port_step(cfg, sd, stacks)
    assert loss == pytest.approx(jl, rel=1e-5)
    model64 = FeedForward.from_config(cfg).double()
    model64.dtype = torch.float64
    model64.load_state_dict(sd, strict=True)
    model64.train()
    out64 = model64(*[torch.from_numpy(s).double() for s in stacks])
    (out64['mean'].abs().mean() + 0.1 * out64['logvar'].mean()).backward()
    grads64 = dict(model64.named_parameters())
    for name, p in model.named_parameters():
        if name.startswith('in_net') and name.endswith('.2.bias'):
            continue        # a conv bias ahead of a train-mode BN: zero
        g = p.grad.double().numpy()
        assert _l2_err(g, want[name].numpy()) <= GRAD_L2, name
        assert _l2_err(g, grads64[name].grad.numpy()) <= GRAD_L2, name
    buffers = dict(model.named_buffers())
    for name in want:
        if name.endswith(('running_mean', 'running_var')):
            assert _rel_err(buffers[name], want[name]) <= TRAIN_TOL, name


def _unet_module(depth, size):
    """The U-Net alone (wf 3) from the JAX module's initial variables, on
    normal inputs, with the weights of a linear loss: the JAX module, its
    variables, the port's state dict, ``x`` and ``wy``."""
    jm = JUNet(2, depth=depth, wf=3)
    rng = np.random.default_rng(3)
    x = rng.standard_normal((2, size, size, 5)).astype(np.float32)
    wy = rng.standard_normal((2, size, size, 2)).astype(np.float32)
    var = jax.tree_util.tree_map(np.asarray, dict(jm.init(
        jax.random.PRNGKey(1), jnp.asarray(x))))
    sd = {}
    _unet_state(var['params'], var['batch_stats'], sd, prefix='',
                depth=depth)
    return jm, var, sd, x, wy


def _unet_module_grads(depth, sd, x, wy, dtype=torch.float32):
    """The port's train-mode gradients of ``mean(y * wy)`` in ``dtype``,
    by parameter name."""
    model = UNet(5, 2, depth=depth, wf=3).to(dtype)
    model.load_state_dict(sd, strict=True)
    model.train()
    y = model(torch.from_numpy(x).to(dtype).permute(0, 3, 1, 2))
    (y * torch.from_numpy(wy).to(dtype).permute(0, 3, 1, 2)).mean().backward()
    return {name: p.grad.numpy() for name, p in model.named_parameters()}


@pytest.mark.parametrize('depth,size', [(3, 32), (5, 32)])
def test_unet_module_grads_match_jax(depth, size):
    """The U-Net alone in train mode on normal inputs (wf 3) under a
    linear loss: every gradient leaf within 5e-3 of its max of the JAX
    module's."""
    jm, var, sd, x, wy = _unet_module(depth, size)

    def jloss(params):
        y, _ = jm.apply({'params': params,
                         'batch_stats': var['batch_stats']},
                        jnp.asarray(x), train=True, mutable=['batch_stats'])
        return jnp.mean(y * wy)

    grads = jax.device_get(jax.grad(jloss)(var['params']))
    want = {}
    _unet_state(grads, var['batch_stats'], want, prefix='', depth=depth)
    for name, g in _unet_module_grads(depth, sd, x, wy).items():
        w = want[name].numpy()
        np.testing.assert_allclose(g, w, rtol=1e-4,
                                   atol=GRAD_TOL * np.abs(w).max(),
                                   err_msg=name)


@pytest.mark.xfail(strict=True, reason='ROADMAP Queue F, "the U-Net\'s fp32 '
                   'gradients at one CPU thread": one thread flips a ReLU '
                   'derivative on these inputs')
def test_unet_module_grads_do_not_depend_on_threads():
    """The depth-5 case above at one torch thread and at two: every fp32
    gradient leaf within 5e-3 of its max of the port's own float64
    gradients at that thread count.  At one thread the fp32 forward rounds
    one pre-activation of ``up_path.2.conv_block.block.0`` (2.0e-5 in
    float64) below zero, and the ReLU's zeroed derivative moves every
    upstream leaf by up to 0.12 of its max; at two threads the worst leaf
    is 2.2e-4 (ROADMAP Queue F)."""
    _, _, sd, x, wy = _unet_module(5, 32)
    threads = torch.get_num_threads()
    try:
        for n in (1, 2):
            torch.set_num_threads(n)
            want = _unet_module_grads(5, sd, x, wy, torch.float64)
            for name, g in _unet_module_grads(5, sd, x, wy).items():
                w = want[name]
                np.testing.assert_allclose(
                    g, w, rtol=1e-4, atol=GRAD_TOL * np.abs(w).max(),
                    err_msg=f'{name} at {n} threads')
    finally:
        torch.set_num_threads(threads)


def test_unet_bf16_matches_jax():
    """``--bf16``: the U-Net rounds where the JAX package's does (bf16
    convs, transposed convs and BN affines, the last 1x1 conv in float32).
    Train mode at 48²: each output within BF16_UNET_TOL of its max (the
    U-Net's 18 bf16 convs and BNs at 3x3 to 48x48 amplify the bf16
    roundings that sum in another order: 5-8% measured on these inputs,
    against 2e-2 for the 11-block trunk in tests/test_torch_bf16.py), and
    at least 3x nearer the JAX bf16 net than the port's float32 net is
    (measured 4-6x), which differs from it."""
    kw = dict(SMALL, bf16=True)
    cfg, jcfg = Config(**kw).finalize(), JConfig(**kw).finalize()
    variables, sd = _variables(cfg)
    stacks = _stacks(2)
    _, jout, _ = _jax_step(jcfg, variables, stacks)
    _, _, out = _port_step(cfg, sd, stacks)
    _, _, out32 = _port_step(Config(**SMALL).finalize(), sd, stacks)
    assert out['mean'].dtype == torch.float32
    for key in ('mean', 'logvar'):
        err = _rel_err(out[key], jout[key])
        assert err <= BF16_UNET_TOL, key
        assert 3 * err < _rel_err(out32[key], jout[key]), key
    assert _rel_err(out['mean'], out32['mean'].detach().numpy()) > 1e-4


def test_pallas_trunk_is_ignored_under_unet():
    """As in the JAX package, ``--pallas_trunk`` leaves a U-Net net on its
    plain path: the same outputs bit for bit."""
    cfg = Config(**SMALL).finalize()
    _, sd = _variables(cfg)
    stacks = _stacks(4)
    outs = []
    for trunk in (False, True):
        model = FeedForward.from_config(Config(**SMALL, pallas_trunk=trunk)
                                        .finalize())
        model.load_state_dict(sd, strict=True)
        model.train()
        with torch.no_grad():
            outs.append(model(*[torch.from_numpy(s) for s in stacks]))
    assert torch.equal(outs[0]['mean'], outs[1]['mean'])


# ------------------------------------------------------- the slice as a whole


@pytest.fixture(scope='module')
def data_dirs(tmp_path_factory):
    root = tmp_path_factory.mktemp('torch_unet')
    train_dir, val_dir = str(root / 'train'), str(root / 'val')
    generate_dataset(train_dir, scenes=2, size=64, seed=0)
    generate_dataset(val_dir, scenes=1, size=64, seed=7)
    return train_dir, val_dir


def _kw(data_dirs, **kw):
    base = dict(train_trainset=data_dirs[0], train_valset=data_dirs[1],
                train_bs=4, train_ps=32, train_lr=1e-5,
                train_max_downscale=1, val_interval=2, val_loss_margin=5,
                train_steps=3, model_chs=8, model_in_blocks=1,
                model_out_blocks=2, model_uncert=True, model_unet=True)
    base.update(kw)
    return base


def _rows(path):
    lines = open(os.path.join(path, 'log.csv')).read().splitlines()
    assert lines[0] == loop.LOG_HEADER
    return [[float(v) for v in line.split(',')] for line in lines[1:]]


def _jax_init(jcfg, ps=32):
    model = JFeedForward.from_config(jcfg)
    variables = model.init(jax.random.PRNGKey(jcfg.train_seed),
                           *[jnp.zeros((1, jcfg.model_views, ps, ps, 3))] * 4)
    return jax.tree_util.tree_map(np.asarray, dict(variables))


@pytest.fixture(scope='module')
def unet_runs(data_dirs, tmp_path_factory):
    """3 steps of the JAX package's train() and of the port's, from the
    same initial variables: ``(jax run dir, port run dir)``."""
    root = tmp_path_factory.mktemp('unet_runs')
    kw = _kw(data_dirs)
    jcfg, cfg = JConfig(**kw).finalize(), Config(**kw).finalize()
    jout, tout = str(root / 'jax'), str(root / 'torch')
    os.makedirs(jout)
    os.makedirs(tout)
    jloop.train(jcfg, jout, progress=False)
    state = loop.train(cfg, tout, progress=False, device='cpu',
                       initial_state=state_dict_from_jax(_jax_init(jcfg),
                                                         cfg))
    assert state.step == 3
    return jout, tout


def test_unet_train_slice_matches_jax(unet_runs):
    """The log rows of 3 U-Net steps (device cache, K1's plain version
    here) agree with the JAX package's, and the checkpoint holds the U-Net
    in the reference's keys."""
    jout, tout = unet_runs
    want, got = _rows(jout), _rows(tout)
    assert [r[0] for r in got] == [r[0] for r in want] == [0, 1, 2]
    np.testing.assert_allclose(np.array(got)[:, 1:5],
                               np.array(want)[:, 1:5], rtol=1e-3)
    ckpt = load_checkpoint(tout)
    assert ckpt['iteration'] == 3 and ckpt['hyper_parameters']['model_unet']
    assert 'out_net.last.weight' in ckpt['model_state_dict']


@pytest.mark.parametrize('ens', [False, True], ids=['upr', 'ese'])
def test_unet_checkpoint_validates_like_jax(unet_runs, data_dirs, tmp_path,
                                            ens):
    """The port's U-Net ``checkpoint.pt`` through both validate CLIs (the
    JAX package reads it as a reference checkpoint), unfolded in both."""
    _, tout = unet_runs
    dirs = []
    for name in ('jax', 'torch'):
        dirs.append(str(tmp_path / name))
        shutil.copytree(tout, dirs[-1])
    kw = dict(val_loss_margin=15, val_ensamble=ens, val_disp_step=1.0)
    want = j_run_validation(dirs[0], data_dirs[1], **kw)
    got = run_validation(dirs[1], data_dirs[1], device='cpu', **kw)
    for k in METRICS:
        assert np.isfinite(got[k]), k
        assert got[k] == pytest.approx(want[k], rel=1e-3, abs=1e-6), k


@pytest.fixture(scope='module')
def jax_unet_run(unet_runs):
    """The JAX-trained U-Net run directory (``checkpoint.msgpack`` only)."""
    jout, _ = unet_runs
    assert os.path.exists(os.path.join(jout, 'checkpoint.msgpack'))
    assert not os.path.exists(os.path.join(jout, 'checkpoint.pt'))
    return jout


@pytest.mark.parametrize('ens', [False, True], ids=['upr', 'ese'])
def test_msgpack_unet_run_validates_like_jax(jax_unet_run, data_dirs,
                                             tmp_path, ens):
    dirs = []
    for name in ('jax', 'torch'):
        dirs.append(str(tmp_path / name))
        shutil.copytree(jax_unet_run, dirs[-1])
    kw = dict(val_loss_margin=15, val_ensamble=ens, val_disp_step=1.0)
    want = j_run_validation(dirs[0], data_dirs[1], **kw)
    got = run_validation(dirs[1], data_dirs[1], device='cpu', **kw)
    for k in METRICS:
        assert got[k] == pytest.approx(want[k], rel=1e-3, abs=1e-6), k


def test_msgpack_unet_run_exports_and_serves_like_jax(jax_unet_run,
                                                      data_dirs):
    """The JAX-trained U-Net: the port's artifact (BatchNorm unfolded)
    against ``mmlf_tpu.export``'s on the same stacks, and the port's server
    against ``mmlf_tpu.serve``'s on a scene."""
    fn, meta = load_exported(export_inference(jax_unet_run, 64, 64),
                             device='cpu')
    assert meta['config']['model_unet'] and \
        not meta['config']['model_no_batchnorm']
    jfn, _ = j_load_exported(j_export(jax_unet_run, 64, 64,
                                      platforms=('cpu',)))
    stacks = _stacks(5, size=64, views=9)
    got = fn(*[torch.from_numpy(s[:1]) for s in stacks])
    want = jfn(*[jnp.asarray(s[:1]) for s in stacks])
    for key in ('mean', 'logvar'):
        assert _rel_err(got[key], want[key]) <= EVAL_TOL, key

    scene = os.path.join(data_dirs[1], 'scene_00')
    got = InferenceEngine(jax_unet_run, device='cpu').infer(scene)
    want = JEngine(jax_unet_run).infer(scene)
    assert got['shape'] == want['shape'] == [64, 64]
    for k in ('mse', 'badpix_007'):
        assert got[k] == pytest.approx(want[k], rel=1e-3, abs=1e-6), k


def test_val_tile_refused_for_unet_like_jax(jax_unet_run, data_dirs,
                                            tmp_path):
    """``--val_tile`` with a U-Net: the JAX package's validate CLI fails
    (its two-window probe never finds the U-Net's output spatial, since
    the pools floor one of the two windows), and the port refuses it up
    front, in validate and in a tiled export, whatever the tile."""
    for tile in (16, 20):
        with pytest.raises(TypeError):
            j_run_validation(jax_unet_run, data_dirs[1], val_tile=tile)
        with pytest.raises(click.UsageError, match='U-Net'):
            run_validation(jax_unet_run, data_dirs[1], val_tile=tile,
                           device='cpu')
        with pytest.raises(ValueError, match='U-Net'):
            export_inference(jax_unet_run, 64, 64, tiled=tile)
