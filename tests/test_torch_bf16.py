"""The port's bfloat16 paths against mmlf_tpu's ``--bf16`` /
``--cache_bf16`` / ``--remat``: K3's bf16 plain versions against
``fused_double_conv`` on bf16 canvases (Pallas, interpret mode), the bf16
BatchNorm against ``FusedBatchNorm``, K1's plain version with a bf16 image
field, the augmentation of a bf16 window, the bf16 ``FeedForward`` (plain
and fused trunk) forward and gradients, and ``--remat``.  The slice as a
whole is in tests/test_torch_bf16_train.py.  Small nets (chs <= 8, 1 + 2
blocks, <= 32² patches)."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from mmlf_tpu.config import Config as JConfig
from mmlf_tpu.data import HCI4D as JHCI4D
from mmlf_tpu.data import pipeline as JP
from mmlf_tpu.data.synth import generate_dataset
from mmlf_tpu.models import FeedForward as JFeedForward
from mmlf_tpu.ops.batchnorm import FusedBatchNorm
from mmlf_tpu.ops.pallas.conv_block import (canvas_dims, from_canvas,
                                            fused_double_conv, to_canvas)
from mmlf_tpu.ops.pallas.window_gather import pallas_window_gather
from mmlf_tpu.utils.convert import torch_state_to_flax
from mmlf_tpu_torch.config import Config
from mmlf_tpu_torch.data import pipeline as P
from mmlf_tpu_torch.data.hci4d import HCI4D
from mmlf_tpu_torch.models.feed_forward import FeedForward, init_live_
from mmlf_tpu_torch.ops.batchnorm import BatchNorm2d
from mmlf_tpu_torch.ops.kernels import conv_block as C
from mmlf_tpu_torch.ops.kernels.window_gather import window_gather
from mmlf_tpu_torch.utils.convert import state_dict_from_jax

import torch_threads  # noqa: F401  torch's share of the CPUs under xdist

GRAD_NAMES = ('dx', 'dsi', 'dti', 'dw1', 'db1', 'dw2', 'db2')


def _rel_err(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))


def _within_ulp(got, want, rel, name):
    """bf16 values: each within one bf16 ulp (at most 2^-7 of its
    magnitude) plus ``rel`` of the largest magnitude."""
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    bound = 2.0 ** -7 * np.abs(want) + rel * np.abs(want).max()
    assert (np.abs(got - want) <= bound).all(), (name, _rel_err(got, want))


# ------------------------------------------------------- K3, bf16 instance


def _block_inputs(seed=3, b=2, h=13, w=17, cin=24, cout=8):
    """tests/test_torch_trunk.py's block inputs (NHWC / HWIO numpy) and the
    weights of its mixed loss."""
    rng = np.random.default_rng(seed)
    f32 = np.float32
    x = rng.standard_normal((b, h, w, cin)).astype(f32)
    si = (np.abs(rng.standard_normal(cin)) + 0.5).astype(f32)
    ti = (rng.standard_normal(cin) * 0.2).astype(f32)
    w1 = (rng.standard_normal((2, 2, cin, cout)) / np.sqrt(4 * cin)).astype(f32)
    b1 = (rng.standard_normal(cout) * 0.1).astype(f32)
    w2 = (rng.standard_normal((2, 2, cout, cout))
          / np.sqrt(4 * cout)).astype(f32)
    b2 = (rng.standard_normal(cout) * 0.1).astype(f32)
    cw = rng.standard_normal((b, h, w, cout)).astype(f32)
    return (x, si, ti, w1, b1, w2, b2), cw


@pytest.mark.parametrize('relu_in,affine_in', [(False, False), (False, True),
                                               (True, False), (True, True)])
def test_k3_bf16_plain_matches_pallas(relu_in, affine_in):
    """K3's bf16 plain versions against the Pallas kernel on bf16 canvases
    (interpret mode), forward and the gradients of a mixed loss of
    ``(y2, ps, pss)``.  Both round at the same points and take exact
    products summed in fp32, so only the summation order differs: y2 and
    dx within one bf16 ulp, the fp32 outputs within 1e-5 of their
    largest magnitude."""
    (x, si, ti, w1, b1, w2, b2), cw = _block_inputs()
    b, h, w, _ = x.shape
    _, _, _, m = canvas_dims(h, w)

    def jblock(x, si, ti, w1, b1, w2, b2):
        y2c, ps, pss = fused_double_conv(
            to_canvas(x.astype(jnp.bfloat16), m), si, ti, w1, b1, w2, b2,
            h, w, relu_in, affine_in, True)
        return from_canvas(y2c, h, w), ps, pss

    def jloss(*args):
        y2, ps, pss = jblock(*args)
        return (jnp.sum(y2.astype(jnp.float32) * cw) + 0.3 * jnp.sum(ps * ps)
                + 0.1 * jnp.sum(pss))

    args = (x, si, ti, w1, b1, w2, b2)
    jy2, jps, jpss = jblock(*args)
    jgrads = jax.grad(jloss, argnums=tuple(range(7)))(*args)

    t = torch.from_numpy
    port = [t(x.transpose(0, 3, 1, 2).copy()).bfloat16(), t(si), t(ti),
            t(w1.transpose(3, 2, 0, 1).copy()), t(b1),
            t(w2.transpose(3, 2, 0, 1).copy()), t(b2)]
    port = [a.requires_grad_() for a in port]
    y2, ps, pss = C.fused_double_conv(*port, relu_in, affine_in)
    assert y2.dtype == torch.bfloat16 and ps.dtype == torch.float32
    loss = ((y2.float() * t(cw.transpose(0, 3, 1, 2).copy())).sum()
            + 0.3 * (ps * ps).sum() + 0.1 * pss.sum())
    loss.backward()

    _within_ulp(y2.detach().float().numpy(),
                np.asarray(jy2.astype(jnp.float32)).transpose(0, 3, 1, 2),
                1e-5, 'y2')
    assert _rel_err(ps.detach(), jps) <= 1e-5
    assert _rel_err(pss.detach(), jpss) <= 1e-5
    want = [np.asarray(g, np.float32) for g in jgrads]
    want[0] = want[0].transpose(0, 3, 1, 2)
    want[3] = want[3].transpose(3, 2, 0, 1)
    want[5] = want[5].transpose(3, 2, 0, 1)
    got = [a.grad.float().numpy() for a in port]
    assert port[0].grad.dtype == torch.bfloat16
    _within_ulp(got[0], want[0], 1e-5, 'dx')
    for name, g, wt in list(zip(GRAD_NAMES, got, want))[1:]:
        if not affine_in and name in ('dsi', 'dti'):
            assert np.abs(g).max() == 0.0 and np.abs(wt).max() == 0.0
            continue
        assert _rel_err(g, wt) <= 1e-5, name


# --------------------------------------------------------------- BatchNorm


@pytest.mark.parametrize('train', [True, False], ids=['train', 'eval'])
def test_bf16_batchnorm_matches_fused(train):
    """The bf16 BatchNorm against ``FusedBatchNorm`` on a bf16 activation
    (tests/test_batchnorm.py's bf16 case): output within one bf16 ulp;
    dx, dγ, dβ and the running statistics in train mode.  The statistics
    are fp32 means of the same values (the port's var_mean against JAX's
    E[x²] − E[x]²): the fp32 outputs within 1e-4 of their largest
    magnitude."""
    rng = np.random.default_rng(1)
    xn = (rng.standard_normal((4, 7, 9, 6)) * 2.0 + 1.5).astype(np.float32)
    x16 = jnp.asarray(xn, jnp.bfloat16)
    gamma = rng.uniform(0.5, 1.5, 6).astype(np.float32)
    beta = rng.uniform(-0.5, 0.5, 6).astype(np.float32)
    mean0 = rng.uniform(-0.2, 0.2, 6).astype(np.float32)
    var0 = rng.uniform(0.8, 1.2, 6).astype(np.float32)
    dy = rng.standard_normal((4, 7, 9, 6)).astype(np.float32)
    variables = {'params': {'scale': gamma, 'bias': beta},
                 'batch_stats': {'mean': mean0, 'var': var0}}
    bn = FusedBatchNorm(momentum=0.7)

    def jloss(v, x):
        y, mut = bn.apply(v, x, use_running_average=not train,
                          mutable=['batch_stats'])
        return jnp.sum(y.astype(jnp.float32) * dy), (y, mut)

    (_, (jy, jmut)), (jgv, jgx) = jax.value_and_grad(
        jloss, argnums=(0, 1), has_aux=True)(variables, x16)

    port = BatchNorm2d(6, momentum=0.3)
    with torch.no_grad():
        port.weight.copy_(torch.from_numpy(gamma))
        port.bias.copy_(torch.from_numpy(beta))
        port.running_mean.copy_(torch.from_numpy(mean0))
        port.running_var.copy_(torch.from_numpy(var0))
    port.train(train)
    x = torch.from_numpy(np.array(x16.astype(jnp.float32))).permute(
        0, 3, 1, 2).bfloat16().requires_grad_()
    y = port(x)
    assert y.dtype == torch.bfloat16
    (y.float() * torch.from_numpy(dy).permute(0, 3, 1, 2)).sum().backward()

    nchw = (0, 3, 1, 2)
    _within_ulp(y.detach().float().numpy(),
                np.asarray(jy.astype(jnp.float32)).transpose(nchw), 1e-4,
                'y')
    assert x.grad.dtype == torch.bfloat16
    _within_ulp(x.grad.float().numpy(),
                np.asarray(jgx.astype(jnp.float32)).transpose(nchw), 1e-4,
                'dx')
    # train: dγ, dβ are the fp32 sums of the canonical backward; eval: they
    # flow back through the bf16 casts of s and t, whose gradients the two
    # packages reduce in bf16 each in their own order (5e-2, the
    # gradient tolerance of the model tests below)
    tol = (1e-4, 1e-5) if train else (5e-2, 5e-2)
    assert _rel_err(port.weight.grad, jgv['params']['scale']) <= tol[0]
    assert _rel_err(port.bias.grad, jgv['params']['bias']) <= tol[1]
    stats = jmut['batch_stats']
    assert _rel_err(port.running_mean, stats['mean']) <= 1e-5
    assert _rel_err(port.running_var, stats['var']) <= 1e-5


# -------------------------------------------------------- K1, augmentation


@pytest.fixture(scope='module')
def root(tmp_path_factory):
    path = str(tmp_path_factory.mktemp('torch_bf16'))
    generate_dataset(path, scenes=2, size=64, seed=0)
    return path


@pytest.fixture(scope='module')
def pipes(root):
    kw = dict(train_ps=32, train_max_downscale=2, train_shift=0.5,
              cache_bf16=True)
    jpipe = JP.DevicePipeline(JHCI4D(root, cache=True),
                              JConfig(**kw).finalize(), seed=11)
    tpipe = P.DevicePipeline(HCI4D(root, cache=True), Config(**kw).finalize(),
                             seed=11, device='cpu')
    return jpipe, tpipe


@pytest.mark.parametrize('with_mpi', [True, False])
def test_window_gather_bf16_bit_identical(pipes, with_mpi):
    """The bf16 cache is the JAX package's to the bit, and K1's plain
    version cuts the same bf16 windows as the Pallas kernel."""
    jpipe, tpipe = pipes
    for a, b in zip(jpipe.cache.img, tpipe.cache.img):
        assert b.dtype == torch.bfloat16
        np.testing.assert_array_equal(
            np.asarray(a).view(np.uint16), b.view(torch.int16).numpy()
            .view(np.uint16))
    db = tpipe.sample_batch(6)
    c = jpipe.cache
    want = pallas_window_gather(c.img, c.aux, c.mpi, db.scene, db.factor - 1,
                                db.ws_y, db.ws_x, tpipe.win,
                                with_mpi=with_mpi, interpret=True)
    got = window_gather(tpipe.cache.img, tpipe.cache.aux, tpipe.cache.mpi,
                        db.scene, db.factor - 1, db.ws_y, db.ws_x, tpipe.win,
                        with_mpi=with_mpi)
    assert got[0].dtype == torch.bfloat16
    np.testing.assert_array_equal(
        got[0].view(torch.int16).numpy().view(np.uint16),
        np.asarray(want[0]).view(np.uint16))
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(want[1]))
    if with_mpi:
        np.testing.assert_array_equal(got[2].numpy(), np.asarray(want[2]))
    else:
        assert got[2] is None


def test_gather_augment_cache_bf16_matches_jax(root, pipes):
    """``gather_augment`` on the bf16 cache against the JAX package's fused
    path, at its own bf16 tolerance (tests/test_augment2.py: atol 2e-2),
    and against the port's float32 path within it."""
    jpipe, tpipe = pipes
    db = tpipe.sample_batch(8)
    db = db._replace(aug=db.aug._replace(
        rot_k=np.array([0, 2, 0, 2, 1, 3, 1, 3], np.int32)))
    got = P.gather_augment(tpipe.cache, db, 32, tpipe.win)
    want = JP.gather_augment(jpipe.cache, db, 32, jpipe.win, parity=True,
                             fold=True)
    for k, name in enumerate(('h', 'v', 'i', 'd', 'gt', 'mpi', 'mask')):
        w = np.asarray(want[k])
        if k < 4:
            w = w.transpose(0, 3, 1, 2)
        assert got[k].dtype == (torch.int32 if name == 'mask'
                                else torch.float32)
        np.testing.assert_allclose(got[k].numpy(), w, atol=2e-2,
                                   err_msg=name)
    f32 = P.DevicePipeline(HCI4D(root, cache=True),
                           Config(train_ps=32, train_max_downscale=2,
                                  train_shift=0.5).finalize(), seed=11,
                           device='cpu')
    ref = P.gather_augment(f32.cache, db, 32, f32.win)
    diff = max(float((g - r).abs().max()) for g, r in zip(got[:4], ref[:4]))
    assert 0.0 < diff <= 2e-2        # the bf16 path rounds, and only so much


# -------------------------------------------------------------- the model

SMALL = dict(model_chs=6, model_views=3, model_in_blocks=1,
             model_out_blocks=2, model_uncert=True,
             model_batchnorm_momentum=0.3)


def _variables(cfg):
    """Input-sensitive variables of ``cfg``'s net, as the JAX package's tree
    and as the port's state dict."""
    live = init_live_(FeedForward.from_config(Config(**SMALL).finalize()),
                      seed=1)
    variables = torch_state_to_flax(
        {k: v.numpy() for k, v in live.state_dict().items()},
        in_blocks=cfg.model_in_blocks, out_blocks=cfg.model_out_blocks,
        no_batchnorm=cfg.model_no_batchnorm, cross=cfg.model_cross)
    return variables, state_dict_from_jax(variables, cfg)


def _stacks(seed=0):
    rng = np.random.default_rng(seed)
    return [rng.random((2, 3, 12, 14, 3), dtype=np.float32)
            for _ in range(4)]


def _port_step(cfg, sd, stacks):
    """Train-mode forward and backward of the port: ``(model, loss,
    output)``."""
    model = FeedForward.from_config(cfg)
    model.load_state_dict(sd, strict=True)
    model.train()
    out = model(*[torch.from_numpy(s) for s in stacks])
    loss = out['mean'].abs().mean() + 0.1 * out['logvar'].mean()
    loss.backward()
    return model, float(loss.detach()), out


def _jax_step(jcfg, variables, stacks):
    """The JAX package's train-mode loss, output, updated BN statistics and
    gradients (as a port state dict)."""
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


# bf16 tolerances (the rounding points agree; the bf16 convolutions may sum
# in another order, so a value near a bf16 rounding boundary can round the
# other way and the difference propagates through the trunk): outputs
# within 2e-2 of their largest magnitude, each gradient leaf within 5e-2 of
# its largest magnitude.  A conv bias is added to a bf16 activation, so its
# gradient is the sum of a bf16 cotangent over (B, H, W): the JAX package
# reduces it in bf16 on the CPU (up to ~12% of the leaf's max off its own
# float32 reduction on these nets), the port in fp32, so conv biases are
# held at BIAS_TOL.
OUT_TOL, GRAD_TOL, BIAS_TOL = 2e-2, 5e-2, 0.15


@pytest.mark.parametrize('trunk', [False, True], ids=['plain', 'trunk'])
def test_feed_forward_bf16_matches_jax(trunk):
    """``FeedForward`` with ``bf16`` in train mode against the JAX
    package's from the same variables: the output, the loss, every
    gradient and the BN running statistics, on the plain trunk and on
    K3's trunk (its plain versions here, the Pallas kernel in interpret
    mode there).  The bf16 output must differ from the float32 one: a
    path that silently ran float32 would pass the tolerances."""
    kw = dict(SMALL, pallas_trunk=trunk)
    cfg = Config(bf16=True, **kw).finalize()
    jcfg = JConfig(bf16=True, **kw).finalize()
    variables, sd = _variables(cfg)
    stacks = _stacks()

    jl, jout, want = _jax_step(jcfg, variables, stacks)
    model, loss, out = _port_step(cfg, sd, stacks)
    assert out['mean'].dtype == torch.float32
    for key in ('mean', 'logvar'):
        assert _rel_err(out[key].detach(), jout[key]) <= OUT_TOL, key
    assert loss == pytest.approx(jl, rel=OUT_TOL)
    for name, p in model.named_parameters():
        w = want[name].numpy()
        if name.endswith('.2.bias') and \
                name.replace('.2.bias', '.3.weight') in want:
            # a conv bias feeding a train-mode BN: a zero gradient, rounding
            # noise on both sides
            continue
        conv_bias = name.endswith(('.0.bias', '.2.bias'))
        assert _rel_err(p.grad, w) <= (BIAS_TOL if conv_bias
                                       else GRAD_TOL), name
    buffers = dict(model.named_buffers())
    for name in want:
        if name.endswith(('running_mean', 'running_var')):
            assert _rel_err(buffers[name], want[name]) <= OUT_TOL, name

    _, _, out32 = _port_step(Config(**kw).finalize(), sd, stacks)
    assert _rel_err(out['mean'].detach(), out32['mean'].detach()) > 1e-4


@pytest.mark.parametrize('bf16', [False, True], ids=['fp32', 'bf16'])
def test_remat_is_bit_equal(bf16):
    """``--remat`` recomputes every train-mode block in the backward: on the
    CPU the loss, every gradient and the BN running statistics (updated
    once per step, not again in the recomputation) equal the run without
    it bit for bit; eval mode ignores it."""
    cfg = Config(bf16=bf16, **SMALL).finalize()
    _, sd = _variables(cfg)
    stacks = _stacks(1)
    ref, ref_loss, _ = _port_step(cfg, sd, stacks)
    model, loss, _ = _port_step(Config(bf16=bf16, remat=True, **SMALL)
                                .finalize(), sd, stacks)
    assert loss == ref_loss
    for (name, p), q in zip(model.named_parameters(), ref.parameters()):
        assert torch.equal(p.grad, q.grad), name
    for (name, b), c in zip(model.named_buffers(), ref.buffers()):
        assert torch.equal(b, c), name
    model.eval()
    ref.eval()
    with torch.no_grad():
        x = [torch.from_numpy(s) for s in stacks]
        assert torch.equal(model(*x)['mean'], ref(*x)['mean'])


def test_remat_matches_jax():
    """``--remat`` against the JAX package's ``--remat`` (``nn.remat``
    blocks), float32, at tests/test_torch_train.py's BN gradient
    tolerance."""
    kw = dict(SMALL, remat=True)
    cfg, jcfg = Config(**kw).finalize(), JConfig(**kw).finalize()
    variables, sd = _variables(cfg)
    stacks = _stacks(2)
    jl, _, want = _jax_step(jcfg, variables, stacks)
    model, loss, _ = _port_step(cfg, sd, stacks)
    assert loss == pytest.approx(jl, rel=1e-5)
    for name, p in model.named_parameters():
        w = want[name].numpy()
        if name.endswith('.2.bias') and \
                name.replace('.2.bias', '.3.weight') in want:
            continue
        np.testing.assert_allclose(p.grad.numpy(), w, rtol=1e-4,
                                   atol=5e-3 * np.abs(w).max(), err_msg=name)
