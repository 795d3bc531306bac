"""The port's fused trunk (``--pallas_trunk``, kernel K3) against
mmlf_tpu's: the plain K3 versions against ``fused_double_conv`` (Pallas,
interpret mode) forward and gradients, and ``FeedForward(pallas_trunk=True)``
in train mode against the JAX package's from the same variables (loss, BN
running statistics, gradients) and against the port's plain path."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from mmlf_tpu.config import Config as JConfig
from mmlf_tpu.models import FeedForward as JFeedForward
from mmlf_tpu.ops.pallas.conv_block import (canvas_dims, from_canvas,
                                            fused_double_conv, to_canvas)
from mmlf_tpu.utils.convert import torch_state_to_flax
from mmlf_tpu_torch.config import Config
from mmlf_tpu_torch.models.feed_forward import FeedForward, init_live_
from mmlf_tpu_torch.models.pallas_trunk import orient_kernel
from mmlf_tpu_torch.ops.kernels import conv_block as C
from mmlf_tpu_torch.utils.convert import state_dict_from_jax

import torch_threads  # noqa: F401  torch's share of the CPUs under xdist

# (relu_in, affine_in): an inner block and the chain entry
VARIANTS = [(True, True), (False, False)]
GRAD_NAMES = ('dx', 'dsi', 'dti', 'dw1', 'db1', 'dw2', 'db2')


def _block_inputs(seed=3, b=2, h=13, w=17, cin=24, cout=8):
    """The inputs of tests/test_pallas.py's fused-block test, NHWC/HWIO
    numpy, plus the loss weights of its mixed loss."""
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


def _to_port(x, si, ti, w1, b1, w2, b2):
    """NHWC / HWIO numpy → the port's NCHW / OIHW tensors."""
    t = torch.from_numpy
    return (t(x.transpose(0, 3, 1, 2).copy()), t(si), t(ti),
            t(w1.transpose(3, 2, 0, 1).copy()), t(b1),
            t(w2.transpose(3, 2, 0, 1).copy()), t(b2))


def _jax_block(relu_in, affine_in, h, w):
    _, _, _, m = canvas_dims(h, w)

    def fn(x, si, ti, w1, b1, w2, b2):
        y2c, ps, pss = fused_double_conv(to_canvas(x, m), si, ti, w1, b1,
                                         w2, b2, h, w, relu_in, affine_in,
                                         True)
        return from_canvas(y2c, h, w), ps, pss
    return fn


def _mixed_loss_jax(fn, cw):
    def loss(*args):
        y2, ps, pss = fn(*args)
        return (jnp.sum(y2 * cw) + 0.3 * jnp.sum(ps * ps)
                + 0.1 * jnp.sum(pss))
    return loss


def _mixed_loss_port(y2, ps, pss, cw):
    cw = torch.from_numpy(cw.transpose(0, 3, 1, 2).copy())
    return (y2 * cw).sum() + 0.3 * (ps * ps).sum() + 0.1 * pss.sum()


@pytest.mark.parametrize('relu_in,affine_in', VARIANTS)
def test_plain_fwd_matches_pallas(relu_in, affine_in):
    """Ragged 13×17, Cin 24 → Cout 8 (tests/test_pallas.py's shape)."""
    args, _ = _block_inputs()
    want = _jax_block(relu_in, affine_in, 13, 17)(
        *[jnp.asarray(a) for a in args])
    got = C.fused_double_conv_fwd(*_to_port(*args), relu_in, affine_in)
    np.testing.assert_allclose(got[0].permute(0, 2, 3, 1).numpy(),
                               np.asarray(want[0]), rtol=2e-5, atol=2e-5,
                               err_msg='y2')
    for g, w, name in zip(got[1:], want[1:], ('ps', 'pss')):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=2e-5,
                                   atol=2e-5, err_msg=name)


@pytest.mark.parametrize('relu_in,affine_in', VARIANTS)
def test_autograd_matches_jax_grad(relu_in, affine_in):
    """The autograd Function on the CPU (plain versions) against jax.grad of
    the Pallas kernel, through a loss that mixes y2, ps and pss."""
    args, cw = _block_inputs()
    want = jax.grad(_mixed_loss_jax(_jax_block(relu_in, affine_in, 13, 17),
                                    jnp.asarray(cw)),
                    argnums=tuple(range(7)))(*[jnp.asarray(a) for a in args])
    port = [a.requires_grad_() for a in _to_port(*args)]
    loss = _mixed_loss_port(*C.fused_double_conv(*port, relu_in, affine_in),
                            cw)
    got = torch.autograd.grad(loss, port)
    layout = {'dx': (0, 2, 3, 1), 'dw1': (2, 3, 1, 0), 'dw2': (2, 3, 1, 0)}
    for g, w, name in zip(got, want, GRAD_NAMES):
        g = g.permute(*layout[name]) if name in layout else g
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=3e-4,
                                   atol=3e-4, err_msg=name)


@pytest.mark.parametrize('relu_in,affine_in',
                         VARIANTS + [(True, False)])
def test_plain_bwd_matches_autograd(relu_in, affine_in):
    """``plain_double_conv_bwd``'s written-out formulas against torch
    autograd of the plain forward (float64: both exact to rounding)."""
    args, cw = _block_inputs(seed=4, b=2, h=9, w=11, cin=12, cout=10)
    port = [a.double().requires_grad_() for a in _to_port(*args)]
    out = C.plain_double_conv_fwd(*port, relu_in, affine_in)
    cw_t = torch.from_numpy(cw.transpose(0, 3, 1, 2).copy()).double()
    loss = (out[0] * cw_t).sum() + 0.3 * (out[1] * out[1]).sum() \
        + 0.1 * out[2].sum()
    want = torch.autograd.grad(loss, port, allow_unused=True)
    with torch.no_grad():
        got = C.plain_double_conv_bwd(
            *port[:6], out[0], cw_t, 0.6 * out[1], torch.full_like(out[2],
                                                                   0.1),
            relu_in, affine_in)
    for g, w, name in zip(got, want, GRAD_NAMES):
        w = torch.zeros_like(g) if w is None else w
        torch.testing.assert_close(g, w, rtol=1e-10, atol=1e-10, msg=name)


def test_orient_kernel_matches_activation_transforms():
    """A 't' / 'tf' kernel on the data equals the plain path's transpose
    (and mirror) of the activations around the unoriented kernel."""
    rng = np.random.default_rng(0)
    x = torch.from_numpy(rng.standard_normal((2, 3, 7, 9)).astype('f4'))
    w = torch.from_numpy(rng.standard_normal((4, 3, 2, 2)).astype('f4'))
    conv = torch.nn.functional.conv2d
    for pad in (0, 1):
        want_t = conv(x.transpose(2, 3), w, padding=pad).transpose(2, 3)
        want_tf = conv(x.transpose(2, 3).flip(-1), w,
                       padding=pad).flip(-1).transpose(2, 3)
        torch.testing.assert_close(conv(x, orient_kernel(w, 't'),
                                        padding=pad), want_t)
        torch.testing.assert_close(conv(x, orient_kernel(w, 'tf'),
                                        padding=pad), want_tf)
        assert torch.equal(orient_kernel(w, 'n'), w)


# ------------------------------------------------------ the whole trunk

SMALL = dict(model_chs=6, model_views=3, model_in_blocks=1,
             model_out_blocks=3, model_uncert=True,
             model_batchnorm_momentum=0.3)
NETS = {'upr': {}, 'no_batchnorm': {'model_no_batchnorm': True}}


def _train_loss_port(model, stacks):
    out = model(*[torch.from_numpy(s) for s in stacks])
    return out['mean'].abs().mean() + 0.1 * out['logvar'].mean(), out


def _run_port(cfg, sd, stacks):
    model = FeedForward.from_config(cfg)
    model.load_state_dict(sd, strict=True)
    model.train()
    loss, out = _train_loss_port(model, stacks)
    loss.backward()
    return model, float(loss.detach()), out


@pytest.mark.parametrize('net', list(NETS))
def test_feed_forward_trunk_matches_jax(net):
    """FeedForward(pallas_trunk=True) in train mode against the JAX
    package's, from the same input-sensitive variables: loss, updated BN
    running statistics and every gradient; and against the port's plain
    path (the same function)."""
    kw = dict(SMALL, **NETS[net])
    cfg = Config(pallas_trunk=True, **kw).finalize()
    jcfg = JConfig(pallas_trunk=True, **kw).finalize()
    live = init_live_(FeedForward.from_config(cfg), seed=1)
    variables = torch_state_to_flax(
        {k: v.numpy() for k, v in live.state_dict().items()},
        in_blocks=cfg.model_in_blocks, out_blocks=cfg.model_out_blocks,
        no_batchnorm=cfg.model_no_batchnorm, cross=cfg.model_cross)
    sd = state_dict_from_jax(variables, cfg)

    rng = np.random.default_rng(0)
    stacks = [rng.random((2, 3, 10, 13, 3), dtype=np.float32)
              for _ in range(4)]

    jmodel = JFeedForward.from_config(jcfg)

    def jloss(params, stats):
        out, mut = jmodel.apply({'params': params, 'batch_stats': stats},
                                *[jnp.asarray(s) for s in stacks],
                                train=True, mutable=['batch_stats'])
        return (jnp.mean(jnp.abs(out['mean']))
                + 0.1 * jnp.mean(out['logvar'])), mut['batch_stats']

    (jl, jstats), jgrads = jax.value_and_grad(jloss, has_aux=True)(
        variables['params'], variables.get('batch_stats', {}))
    want = state_dict_from_jax({'params': jax.device_get(jgrads),
                                'batch_stats': jax.device_get(jstats)}, cfg)

    n_fwd = C.fused_double_conv_fwd.launches
    model, loss, _ = _run_port(cfg, sd, stacks)
    assert C.fused_double_conv_fwd.launches == n_fwd    # CPU: plain only
    np.testing.assert_allclose(loss, float(jl), rtol=1e-5)
    # per leaf: no BN, the same fp32 sums in another order; with BN, as in
    # tests/test_torch_train.py, the BN of both packages takes the
    # variance as E[y²] − E[y]² and loses digits to cancellation
    rel = 1e-4 if cfg.model_no_batchnorm else 5e-3
    g_max = max(float(np.abs(g.numpy()).max()) for g in want.values())
    for name, p in model.named_parameters():
        w = want[name].numpy()
        if name.replace('.2.bias', '.3.weight') in want and \
                name.endswith('.2.bias'):
            # a conv bias feeding a train-mode BN: its gradient is zero,
            # both sides hold rounding noise
            assert np.abs(p.grad.numpy()).max() < 1e-5 * g_max, name
            assert np.abs(w).max() < 1e-5 * g_max, name
            continue
        np.testing.assert_allclose(p.grad.numpy(), w, rtol=1e-4,
                                   atol=rel * max(np.abs(w).max(), 1e-12),
                                   err_msg=name)
    buffers = dict(model.named_buffers())
    n_bn = 0
    for name in want:
        if name.endswith(('running_mean', 'running_var')):
            w = want[name].numpy()
            np.testing.assert_allclose(buffers[name].numpy(), w, rtol=1e-5,
                                       atol=1e-5 * np.abs(w).max(),
                                       err_msg=name)
            n_bn += 1
    if not cfg.model_no_batchnorm:
        assert n_bn == 2 * (cfg.model_in_blocks * (1 if cfg.model_cross
                                                   else 2)
                            + cfg.model_out_blocks - 1)

    # the port's plain path from the same weights: same loss, grads, stats
    plain, ploss, pout = _run_port(
        Config(**kw).finalize(), sd, stacks)
    np.testing.assert_allclose(loss, ploss, rtol=1e-5)
    g_max = max(float(p.grad.abs().max()) for p in plain.parameters())
    for (name, p), q in zip(model.named_parameters(), plain.parameters()):
        torch.testing.assert_close(p.grad, q.grad, rtol=1e-4,
                                   atol=1e-4 * float(q.grad.abs().max())
                                   + 1e-6 * g_max, msg=name)
    for (name, b), c in zip(model.named_buffers(), plain.buffers()):
        torch.testing.assert_close(b, c, rtol=1e-5, atol=1e-6, msg=name)

    # guard: every stream moves the fused path's output (a wrong
    # orientation would hide behind a dead net)
    with torch.no_grad():
        base = model(*[torch.from_numpy(s) for s in stacks])['mean']
        for s in range(2 if cfg.model_cross else 4):
            z = [torch.from_numpy(x) for x in stacks]
            z[s] = torch.zeros_like(z[s])
            moved = float((model(*z)['mean'] - base).abs().max())
            assert moved > 1e-3, f'stream {s} does not move the output'


def test_eval_mode_takes_the_plain_path():
    """Eval (validation, ESE) never enters K3, as in the JAX package."""
    cfg = Config(pallas_trunk=True, **SMALL).finalize()
    model = init_live_(FeedForward.from_config(cfg), seed=2).eval()
    ref = FeedForward.from_config(Config(**SMALL).finalize())
    ref.load_state_dict(model.state_dict())
    stacks = [torch.rand((1, 3, 10, 12, 3), generator=torch.Generator()
                         .manual_seed(i)) for i in range(4)]
    calls = []
    orig = C._FusedDoubleConv.apply
    C._FusedDoubleConv.apply = lambda *a: calls.append(1) or orig(*a)
    try:
        with torch.no_grad():
            got = model(*stacks)['mean']
        assert not calls
        model.train()
        with torch.no_grad():
            model(*stacks)
        assert len(calls) == 4 * 1 + 3
    finally:
        C._FusedDoubleConv.apply = orig
    torch.testing.assert_close(got, ref.eval()(*stacks)['mean'])
