"""Tests of the port that need a CUDA card (they skip without one).

The CUDA kernels have no CPU mode, so each is held here against its plain
PyTorch version on the card.  This file imports neither JAX nor mmlf_tpu,
so it also runs where JAX is not installed:

    python -m pytest --noconftest tests/test_torch_cuda.py
"""

import os

import numpy as np
import pytest
import torch

from mmlf_tpu_torch.config import Config
from mmlf_tpu_torch.models.ensemble import ensemble_forward
from mmlf_tpu_torch.models.feed_forward import FeedForward, init_live_
from mmlf_tpu_torch.ops.kernels import conv_block as C
from mmlf_tpu_torch.ops.kernels import posterior as K
from mmlf_tpu_torch.ops.kernels import window_gather as W

# the kernel's exponential is ex2.approx on a pre-scaled argument (a few
# ulp), against expf and a division in the plain version
TOL = dict(rtol=1e-4, atol=1e-6)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA card: the kernels have no CPU mode')
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device('cuda')


def _inputs(dev, k, p, kb, seed=0):
    rng = np.random.default_rng(seed)
    means = rng.uniform(-3, 3, (k, p)).astype(np.float32)
    scales = rng.uniform(0.05, 2.0, (k, p)).astype(np.float32)
    bins = np.linspace(-3.5, 3.5, kb).astype(np.float32)
    return [torch.from_numpy(a).to(dev) for a in (means, scales, bins)]


@pytest.mark.parametrize('k,p,kb', [(70, 512 * 512, 70), (7, 300, 11),
                                    (3, 33, 200), (1, 1, 1), (33, 100, 256)])
def test_mixture_kernel_matches_plain(cuda, k, p, kb):
    means, scales, bins = _inputs(cuda, k, p, kb, seed=k + p + kb)
    before = K.laplace_mixture_posterior.launches
    got = K.laplace_mixture_posterior(means, scales, bins)
    torch.cuda.synchronize()
    assert K.laplace_mixture_posterior.launches == before + 1
    assert got.shape == (p, kb)
    torch.testing.assert_close(
        got, K.plain_mixture_posterior(means, scales, bins), **TOL)


# each output's error against a float64 evaluation stays within this factor
# of the fp32 plain version's (expf and a division per term), where the
# kernel takes its exponentials from MUFU.EX2 (~2 ulp) and, for a share of
# the bins, from the polynomial of csrc/exp2_poly.cuh (<= 2e-7 relative)
K2_PREC_FACTOR = 4.0


@pytest.mark.parametrize('k,p', [(70, 512 * 512), (70, 310 * 310),
                                 (141, 512 * 512)],
                         ids=['scene', 'tile', 'disp_step_0.05'])
def test_mixture_kernel_fp32_accurate(cuda, k, p):
    """At the ESE's K = Kb = 70, for the whole 512² scene and one
    ``--val_tile 256`` window (310², ragged against the 32-pixel tile), and
    at ``--val_disp_step 0.05``'s K = Kb = 141 (16 bins a thread, two
    passes, no register cap), with scales exp(logvar), logvar in [-3, 1]."""
    rng = np.random.default_rng(p)
    means = torch.from_numpy(
        rng.uniform(-3.5, 3.5, (k, p)).astype(np.float32)).to(cuda)
    scales = torch.exp(torch.from_numpy(
        rng.uniform(-3.0, 1.0, (k, p)).astype(np.float32)).to(cuda))
    bins = torch.from_numpy(
        np.linspace(-3.5, 3.5, k).astype(np.float32)).to(cuda)
    got = K.laplace_mixture_posterior(means, scales, bins)
    plain = K.plain_mixture_posterior(means, scales, bins)
    ref = K.plain_mixture_posterior(means.double(), scales.double(),
                                    bins.double())
    torch.testing.assert_close(got, plain, **TOL)
    e_k = float((got.double() - ref).abs().max())
    e_p = float((plain.double() - ref).abs().max())
    floor = 2.0 ** -24 * float(ref.abs().max())
    assert e_k <= K2_PREC_FACTOR * max(e_p, floor), (e_k, e_p)


def test_mixture_kernel_rejects_too_many_bins(cuda):
    means, scales, bins = _inputs(cuda, 2, 8, K.max_bins() + 1)
    with pytest.raises(ValueError, match='bins'):
        K.laplace_mixture_posterior(means, scales, bins)


def test_ensemble_on_card_matches_cpu(cuda):
    cfg = Config(model_chs=8, model_views=9, model_in_blocks=1,
                 model_out_blocks=2, model_uncert=True).finalize()
    model = init_live_(FeedForward.from_config(cfg), seed=3).eval()
    rng = np.random.default_rng(4)
    stacks = [torch.from_numpy(rng.random((1, 9, 40, 48, 3),
                                          dtype=np.float32))
              for _ in range(4)]
    want = ensemble_forward(model, *stacks, -3.5, 3.5, 0.1)
    before = K.laplace_mixture_posterior.launches
    got = ensemble_forward(model.to(cuda), *[s.to(cuda) for s in stacks],
                           -3.5, 3.5, 0.1)
    torch.cuda.synchronize()
    assert K.laplace_mixture_posterior.launches == before + 1
    for key in ('means', 'logvars'):
        torch.testing.assert_close(got[key].cpu(), want[key], rtol=0,
                                   atol=5e-4)
    agree = (got['mean'].cpu() - want['mean']).abs() < 5e-4
    assert agree.float().mean() >= 0.999
    torch.testing.assert_close(got['posterior'].cpu(), want['posterior'],
                               rtol=1e-3, atol=1e-4)


def test_tiled_ensemble_on_card_matches_cpu(cuda):
    """``--val_tile``'s forward: the ensemble per window on the card, K2
    launched once per tile, against the same tiled forward on the CPU."""
    from mmlf_tpu_torch.validate.tiling import (receptive_radius,
                                                tile_positions,
                                                tiled_forward)
    cfg = Config(model_chs=8, model_views=9, model_in_blocks=1,
                 model_out_blocks=2, model_uncert=True).finalize()
    model = init_live_(FeedForward.from_config(cfg), seed=3).eval()
    rng = np.random.default_rng(5)
    stacks = [torch.from_numpy(rng.random((1, 9, 72, 88, 3),
                                          dtype=np.float32))
              for _ in range(4)]
    halo = receptive_radius(2, 1, 2) + 5
    n_tiles = len(tile_positions(72, 88, 32, halo))

    def run(m, s):
        return tiled_forward(lambda *w: ensemble_forward(m, *w, -3.5, 3.5,
                                                         0.1), s, 32, halo)
    want = run(model, stacks)
    before = K.laplace_mixture_posterior.launches
    got = run(model.to(cuda), [s.to(cuda) for s in stacks])
    torch.cuda.synchronize()
    assert K.laplace_mixture_posterior.launches == before + n_tiles
    for key in ('means', 'logvars'):
        assert got[key].shape == (70, 1, 72, 88)
        torch.testing.assert_close(got[key].cpu(), want[key], rtol=0,
                                   atol=5e-4)
    torch.testing.assert_close(got['posterior'].cpu(), want['posterior'],
                               rtol=1e-3, atol=1e-4)


def _levels(dev, n_scenes=4, size=512, n_levels=4, seed=0):
    """Random packed pyramid levels at the recipe's layout (CI 128)."""
    gen = torch.Generator(device=dev).manual_seed(seed)
    img, aux, mpi = [], [], []
    for f in range(1, n_levels + 1):
        hf = (size + f - 1) // f
        img.append(torch.rand((n_scenes, hf, hf, 128), generator=gen,
                              device=dev))
        aux.append(torch.rand((n_scenes, hf, hf * W.AUX_CH), generator=gen,
                              device=dev))
        mpi.append(torch.rand((n_scenes, hf, hf * W.MPI_CH), generator=gen,
                              device=dev))
    return img, aux, mpi


@pytest.mark.parametrize('with_mpi', [False, True])
def test_window_gather_kernel_matches_plain(cuda, with_mpi):
    """K1 at the recipe shape (64 windows of 128², all four levels) is a
    copy: bit-identical to the plain version."""
    img, aux, mpi = _levels(cuda)
    rng = np.random.default_rng(1)
    b, win = 64, 128
    level = np.arange(b) % 4
    hf = np.array([t.shape[1] for t in img])[level]
    wy = rng.integers(0, hf - win + 1) // 8 * 8
    wx = rng.integers(0, hf - win + 1) // 16 * 16
    scene = rng.integers(0, 4, b)
    before = W.window_gather.launches
    got = W.window_gather(img, aux, mpi, scene, level, wy, wx, win,
                          with_mpi=with_mpi)
    torch.cuda.synchronize()
    assert W.window_gather.launches == before + 1
    index = np.stack([scene, level, wy, wx]).astype(np.int32)
    want = W.plain_window_gather(img, aux, mpi, index, win, with_mpi)
    for g, w in zip(got, want):
        if w is None:
            assert g is None
            continue
        assert torch.equal(g, w)


def _train_step_cpu_and_card(cuda, tmp_path, **kw):
    """One port train step (UPR, accum 2, augmentation on) on the CPU and on
    the card from the same weights and batch: ``[(loss, grads, K1
    launches, K3 forward launches, K3 backward launches)]``, CPU first."""
    from mmlf_tpu_torch.data.hci4d import HCI4D
    from mmlf_tpu_torch.data.pipeline import DevicePipeline
    from mmlf_tpu_torch.data.synth import generate_dataset
    from mmlf_tpu_torch.models.feed_forward import init_default_
    from mmlf_tpu_torch.train import loop

    root = str(tmp_path / 'data')
    generate_dataset(root, scenes=1, size=128, seed=0)
    cfg = Config(train_trainset=root, train_bs=8, train_ps=32,
                 train_lr=1e-3, train_max_downscale=2, train_accum=2,
                 model_chs=8, model_in_blocks=1, model_out_blocks=2,
                 model_uncert=True, **kw).finalize()
    counters = (W.window_gather, C.fused_double_conv_fwd,
                C.fused_double_conv_bwd)
    results = []
    for dev in ('cpu', cuda):
        pipe = DevicePipeline(HCI4D(root, cache=True), cfg, seed=3,
                              device=dev)
        model = init_default_(FeedForward.from_config(cfg), 0).to(dev)
        opt = loop.make_optimizer(model)
        before = [f.launches for f in counters]
        loss = loop.train_step(cfg, model, opt, pipe.cache,
                               pipe.sample_batch(8), 5)
        launches = [f.launches - n for f, n in zip(counters, before)]
        results.append((float(loss), {n: p.grad.cpu() for n, p in
                                      model.named_parameters()},
                        *launches))
    return results


def _assert_step_close(results):
    (l_cpu, g_cpu, *_), (l_gpu, g_gpu, *_) = results
    # the card sums the convolutions in another order (TF32 off);
    # gradients are compared, not Adam's ~sign(g) first update
    assert abs(l_gpu - l_cpu) <= 1e-4 * abs(l_cpu)
    # (a conv bias feeding a train-mode BN has a zero gradient: rounding
    # noise on both sides, held to the model-wide scale)
    g_max = max(float(g.abs().max()) for g in g_cpu.values())
    for name in g_cpu:
        scale = float(g_cpu[name].abs().max())
        torch.testing.assert_close(g_gpu[name], g_cpu[name], rtol=1e-3,
                                   atol=1e-4 * scale + 1e-5 * g_max,
                                   msg=name)


def test_train_step_on_card_matches_cpu(cuda, tmp_path):
    """The plain trunk: cuDNN on the card, K1 launched per microbatch."""
    results = _train_step_cpu_and_card(cuda, tmp_path)
    assert [r[2:] for r in results] == [(0, 0, 0), (2, 0, 0)]
    _assert_step_close(results)


def test_trunk_train_step_on_card_matches_cpu(cuda, tmp_path):
    """``--pallas_trunk``: every train-mode block through K3 on the card
    (4 streams + 2 out_net blocks per microbatch), the plain versions on
    the CPU."""
    results = _train_step_cpu_and_card(cuda, tmp_path, pallas_trunk=True)
    assert [r[2:] for r in results] == [(0, 0, 0), (2, 12, 12)]
    _assert_step_close(results)


# K3 at the recipe's block shapes (Cin, Cout, relu_in, affine_in): stream
# entry, stream, out_net, UPR head, DPP head, a block without BN
K3_BLOCKS = [(27, 70, False, False), (70, 70, True, True),
             (280, 280, True, True), (280, 2, True, True),
             (280, 108, True, True), (70, 70, True, False)]
# Kernel against plain version (cuDNN with TF32 off): K3's products are
# 3xTF32 (fp32-accurate split products on the tensor cores), cuDNN's fp32
# FFMA, summed in another order, over K = 4 Cin terms per output and
# over up to B·H·W = 590k pixels for the BN sums and the weight
# gradients: each output within 1e-4 of its largest magnitude.  The inputs
# are dyadic (few-bit multiples of powers of two): then x·si + ti and y1
# are exact in fp32 in any summation order, and the ReLU masks [pre > 0]
# and [y1 > 0] agree bit for bit.  With real-valued inputs a few of the
# ~40M pre-activations of a recipe-size block lie within rounding of zero,
# and a flipped relu' moves dx and the sums by O(1).
K3_REL = 1e-4


def _k3_inputs(dev, b, h, w, cin, cout, seed):
    rng = np.random.default_rng(seed)

    def t(lo, hi, shape, scale):
        a = rng.integers(lo, hi + 1, shape).astype(np.float32) * scale
        return torch.from_numpy(a).to(dev)

    x = t(-4, 4, (b, cin, h, w), 1 / 4)
    si, ti = t(2, 6, cin, 1 / 4), t(-4, 4, cin, 1 / 8)
    w1, b1 = t(-3, 3, (cout, cin, 2, 2), 1 / 16), t(-2, 2, cout, 1 / 16)
    w2, b2 = t(-3, 3, (cout, cout, 2, 2), 1 / 16), t(-2, 2, cout, 1 / 16)
    dy2 = t(-4, 4, (b, cout, h, w), 1 / 4)
    dps, dpss = t(-2, 2, cout, 1 / 16), t(-2, 2, cout, 1 / 256)
    return x, si, ti, w1, b1, w2, b2, dy2, dps, dpss


def _assert_rel(got, want, name):
    scale = float(want.abs().max())
    err = float((got - want).abs().max())
    assert got.shape == want.shape, name
    assert err <= K3_REL * scale + 1e-30, (name, err, scale)


@pytest.mark.parametrize('size', [(64, 96, 96), (3, 13, 17)],
                         ids=['recipe', 'ragged'])
@pytest.mark.parametrize('cin,cout,relu_in,affine_in', K3_BLOCKS)
def test_conv_block_kernels_match_plain(cuda, size, cin, cout, relu_in,
                                        affine_in):
    b, h, w = size
    x, si, ti, w1, b1, w2, b2, dy2, dps, dpss = _k3_inputs(
        cuda, b, h, w, cin, cout, seed=cin + cout + h)
    n_fwd, n_bwd = C.fused_double_conv_fwd.launches, \
        C.fused_double_conv_bwd.launches
    got = C.fused_double_conv_fwd(x, si, ti, w1, b1, w2, b2, relu_in,
                                  affine_in)
    want = C.plain_double_conv_fwd(x, si, ti, w1, b1, w2, b2, relu_in,
                                   affine_in)
    for g, wt, name in zip(got, want, ('y2', 'ps', 'pss')):
        _assert_rel(g, wt, name)
    y2 = want[0]
    got = C.fused_double_conv_bwd(x, si, ti, w1, b1, w2, y2, dy2, dps, dpss,
                                  relu_in, affine_in)
    want = C.plain_double_conv_bwd(x, si, ti, w1, b1, w2, y2, dy2, dps,
                                   dpss, relu_in, affine_in)
    torch.cuda.synchronize()
    assert (C.fused_double_conv_fwd.launches - n_fwd,
            C.fused_double_conv_bwd.launches - n_bwd) == (1, 1)
    for g, wt, name in zip(got, want, ('dx', 'dsi', 'dti', 'dw1', 'db1',
                                       'dw2', 'db2')):
        _assert_rel(g, wt, name)
    if not affine_in:
        assert float(got[1].abs().max() + got[2].abs().max()) == 0.0


def test_conv_block_autograd_on_card(cuda):
    """The autograd Function launches K3 forward and backward once each and
    returns a gradient for every tensor argument."""
    x, si, ti, w1, b1, w2, b2, dy2, dps, dpss = _k3_inputs(
        cuda, 2, 9, 11, 8, 6, seed=0)
    args = [a.requires_grad_() for a in (x, si, ti, w1, b1, w2, b2)]
    n_fwd, n_bwd = C.fused_double_conv_fwd.launches, \
        C.fused_double_conv_bwd.launches
    y2, ps, pss = C.fused_double_conv(*args, True, True)
    loss = (y2 * dy2).sum() + (ps * dps).sum() + (pss * dpss).sum()
    grads = torch.autograd.grad(loss, args)
    want = C.plain_double_conv_bwd(*[a.detach() for a in args[:6]],
                                   y2.detach(), dy2, dps, dpss, True, True)
    assert (C.fused_double_conv_fwd.launches - n_fwd,
            C.fused_double_conv_bwd.launches - n_bwd) == (1, 1)
    for g, w, name in zip(grads, (want[0], want[1], want[2], want[3],
                                  want[4], want[5], want[6]),
                          ('dx', 'dsi', 'dti', 'dw1', 'db1', 'dw2', 'db2')):
        _assert_rel(g, w, name)


# On real-valued inputs each K3 output's error against a float64 evaluation
# of the plain version stays within this factor of the fp32 plain version's
# (cuDNN, TF32 off): 3xTF32 keeps fp32's accuracy, where a kernel that ran
# one TF32 product (11 significant bits) would miss by ~500x.  Dyadic
# inputs cannot show this: they are exact in TF32.
K3_PREC_FACTOR = 4.0


@pytest.mark.parametrize('size', [(64, 96, 96), (3, 13, 17)],
                         ids=['recipe', 'ragged'])
def test_conv_block_kernels_fp32_accurate(cuda, size):
    """280→280 with ``relu_in=False`` and b1 large enough that y1 > 0
    everywhere, so no ReLU mask can flip and the whole block (forward and
    backward) is continuous."""
    from torch.nn import functional as F
    b, h, w = size
    cin = cout = 280
    rng = np.random.default_rng(b + h + w)

    def t(a):
        return torch.from_numpy(np.asarray(a, np.float32)).to(cuda)

    x = t(rng.standard_normal((b, cin, h, w)))
    si, ti = t(rng.uniform(0.5, 1.5, cin)), t(rng.uniform(-0.5, 0.5, cin))
    w1 = t(rng.standard_normal((cout, cin, 2, 2)) / np.sqrt(4 * cin))
    b1 = t(rng.uniform(10.0, 11.0, cout))
    w2 = t(rng.standard_normal((cout, cout, 2, 2)) / np.sqrt(4 * cout))
    b2 = t(rng.uniform(-0.1, 0.1, cout))
    dy2 = t(rng.standard_normal((b, cout, h, w)))
    dps, dpss = t(rng.standard_normal(cout) * 0.1), \
        t(rng.standard_normal(cout) * 0.01)
    d = [a.double() for a in (x, si, ti, w1, b1, w2, b2)]
    pre = d[0] * d[1][:, None, None] + d[2][:, None, None]
    assert float(F.conv2d(pre, d[3], d[4], padding=1).min()) > 0

    got = C.fused_double_conv_fwd(x, si, ti, w1, b1, w2, b2, False, True)
    plain = C.plain_double_conv_fwd(x, si, ti, w1, b1, w2, b2, False, True)
    ref = C.plain_double_conv_fwd(*d, False, True)
    y2 = plain[0]
    got_b = C.fused_double_conv_bwd(x, si, ti, w1, b1, w2, y2, dy2, dps, dpss,
                                    False, True)
    plain_b = C.plain_double_conv_bwd(x, si, ti, w1, b1, w2, y2, dy2, dps,
                                      dpss, False, True)
    ref_b = C.plain_double_conv_bwd(*d[:6], y2.double(), dy2.double(),
                                    dps.double(), dpss.double(), False, True)
    torch.cuda.synchronize()
    names = ('y2', 'ps', 'pss', 'dx', 'dsi', 'dti', 'dw1', 'db1', 'dw2', 'db2')
    for g, p, r, name in zip((*got, *got_b), (*plain, *plain_b),
                             (*ref, *ref_b), names):
        e_k = float((g.double() - r).abs().max())
        e_p = float((p.double() - r).abs().max())
        # floored at one fp32 ulp of the largest magnitude
        floor = 2.0 ** -24 * float(r.abs().max())
        assert e_k <= K3_PREC_FACTOR * max(e_p, floor), (name, e_k, e_p)


def test_conv_block_refused_launch_raises(cuda):
    """A launch the card refuses (here: more shared memory than a block may
    have, from the input affine of 8000 channels) comes back as an error
    code and raises; nothing falls back."""
    x, si, ti, w1, b1, w2, b2, *_ = _k3_inputs(cuda, 1, 3, 3, 8000, 70,
                                                seed=0)
    before = C.fused_double_conv_fwd.launches
    with pytest.raises(RuntimeError, match='CUDA error'):
        C.fused_double_conv_fwd(x, si, ti, w1, b1, w2, b2, True, True)
    assert C.fused_double_conv_fwd.launches == before
    # the refusal is not left behind for the next launch
    x, si, ti, w1, b1, w2, b2, *_ = _k3_inputs(cuda, 1, 3, 3, 8, 6, seed=0)
    got = C.fused_double_conv_fwd(x, si, ti, w1, b1, w2, b2, True, True)
    want = C.plain_double_conv_fwd(x, si, ti, w1, b1, w2, b2, True, True)
    _assert_rel(got[0], want[0], 'y2')


def test_served_ensemble_on_card_matches_cpu(cuda, tmp_path):
    """An ESE artifact served by an engine on the card against one on the
    CPU, K2 launched once per request, with the tolerances of
    ``test_ensemble_on_card_matches_cpu``."""
    from mmlf_tpu_torch.data.synth import generate_dataset
    from mmlf_tpu_torch.export import export_inference, load_exported
    from mmlf_tpu_torch.serve import InferenceEngine
    from mmlf_tpu_torch.utils import pfm
    from mmlf_tpu_torch.utils.convert import save_checkpoint_pt

    cfg = Config(model_chs=8, model_views=9, model_in_blocks=1,
                 model_out_blocks=2, model_uncert=True).finalize()
    model = init_live_(FeedForward.from_config(cfg), seed=3)
    run = tmp_path / 'run'
    run.mkdir()
    save_checkpoint_pt(str(run / 'checkpoint.pt'), model.state_dict(), cfg)
    generate_dataset(str(tmp_path / 'data'), scenes=1, size=48, seed=2)
    scene = str(tmp_path / 'data' / 'scene_00')
    blob = export_inference(str(run), 48, 48, val_ensamble=True,
                            members=True)
    art = tmp_path / 'ese.mmlft'
    art.write_bytes(blob)

    outs = {}
    for dev in ('cpu', 'cuda'):
        engine = InferenceEngine(str(art), device=dev)
        before = K.laplace_mixture_posterior.launches
        for k in range(2):
            resp = engine.infer(scene, out_dir=str(tmp_path / f'{dev}{k}'))
        assert K.laplace_mixture_posterior.launches == before + \
            (2 if dev == 'cuda' else 0)
        outs[dev] = [pfm.load(str(tmp_path / f'{dev}1' / f'{name}.pfm'))
                     for name in ('result', 'uncert')] + [resp]
    (mean_c, lv_c, resp_c), (mean_g, lv_g, resp_g) = outs['cpu'], \
        outs['cuda']
    assert (np.abs(mean_g - mean_c) < 5e-4).mean() >= 0.999
    np.testing.assert_allclose(lv_g, lv_c, atol=5e-4)
    assert resp_g['mse'] == pytest.approx(resp_c['mse'], rel=1e-3)

    rng = np.random.default_rng(6)
    stacks = [rng.random((1, 9, 48, 48, 3), dtype=np.float32)
              for _ in range(4)]
    want = load_exported(blob, 'cpu')[0](*stacks)
    got = load_exported(blob, 'cuda')[0](*stacks)
    for key in ('means', 'logvars'):
        torch.testing.assert_close(got[key].cpu(), want[key], rtol=0,
                                   atol=5e-4)
    torch.testing.assert_close(got['posterior'].cpu(), want['posterior'],
                               rtol=1e-3, atol=1e-4)


# K3's bf16 instance against its plain version, evaluated in float64 (bf16
# activations, float64 parameters: the same rounding points, every sum in
# float64), beside the float32 plain version (fp32 convs, TF32 off, on the
# bf16-rounded operands).  On dyadic inputs the input stage, the conv1 sums
# and so y1 and its ReLU mask are exact in any order.  The later fp32 sums
# (conv2, the dgrads) may put a value the other side of a bf16 rounding
# boundary (y2, g2, dy1's bf16 copy, dx), and a flipped dy1 moves the dgrad
# that sums over it: cuDNN's fp32 dgrad flips ~0.04% of dx at 280->280 by
# more than one ulp, the kernel ~1e-6 (measured on an H100).  So each
# output's max error against the float64 evaluation stays within
# K3_PREC_FACTOR x the float32 plain version's (floored at one ulp of its
# largest magnitude in its dtype), and the share of bf16 elements more
# than one ulp off within the float32 plain version's (floored at 1e-5).
K3_BF16_BLOCKS = [(27, 70, False, False), (70, 70, True, True),
                  (280, 280, True, True), (280, 2, True, True),
                  (280, 108, True, True), (70, 70, True, False)]


def _bf16_errors(got, ref):
    """``(max abs error, share of elements more than one ulp off)`` of
    ``got`` against the float64 ``ref``; one bf16 ulp is at most 2^-7 of
    the magnitude (the share is 0 for float32 outputs)."""
    g, r = got.double(), ref.double()
    err = float((g - r).abs().max())
    if got.dtype != torch.bfloat16:
        return err, 0.0
    off = (g - r).abs() > 2.0 ** -7 * r.abs() + 1e-12
    return err, float(off.double().mean())


def _assert_bf16_accurate(got, plain, ref, name):
    assert got.shape == ref.shape and got.dtype == plain.dtype, name
    e_k, s_k = _bf16_errors(got, ref)
    e_p, s_p = _bf16_errors(plain, ref)
    ulp = 2.0 ** (-8 if got.dtype == torch.bfloat16 else -24)
    floor = ulp * float(ref.abs().max())
    assert e_k <= K3_PREC_FACTOR * max(e_p, floor), (name, e_k, e_p)
    assert s_k <= max(s_p, 1e-5), (name, s_k, s_p)


# (B, H, W[, x's element offset]): the recipe; two ragged shapes, where
# the weight gradients' 32-pixel stages cross images, an image holds an
# odd pixel count (dW2's 13 x 17, dW1's 13 x 15) and the last stage runs
# past the end; one image, so that the channel spans meet both ends of
# the allocation; and x as a view 6 bytes into its buffer (not 16-byte
# aligned, as the spans' bulk copies need: the wrapper copies it)
@pytest.mark.parametrize('size', [(64, 96, 96), (3, 13, 17), (3, 12, 14),
                                  (1, 96, 96), (3, 13, 17, 3)],
                         ids=['recipe', 'ragged', 'ragged_even', 'single',
                              'offset'])
@pytest.mark.parametrize('cin,cout,relu_in,affine_in', K3_BF16_BLOCKS)
def test_conv_block_bf16_kernels_match_plain(cuda, size, cin, cout, relu_in,
                                             affine_in):
    b, h, w = size[:3]
    x, si, ti, w1, b1, w2, b2, dy2, dps, dpss = _k3_inputs(
        cuda, b, h, w, cin, cout, seed=cin + cout + h)
    x, dy2 = x.bfloat16(), dy2.bfloat16()
    if len(size) > 3:
        buf = torch.empty(x.numel() + size[3], dtype=x.dtype, device=cuda)
        x = buf[size[3]:].view(x.shape).copy_(x)
        assert x.data_ptr() % 16 != 0
    d = [a.double() for a in (si, ti, w1, b1, w2, b2, dps, dpss)]
    counts = (C.fused_double_conv_fwd.launches_bf16,
              C.fused_double_conv_bwd.launches_bf16,
              C.fused_double_conv_fwd.launches,
              C.fused_double_conv_bwd.launches)
    fa = (x, si, ti, w1, b1, w2, b2, relu_in, affine_in)
    got = C.fused_double_conv_fwd(*fa)
    plain = C.plain_double_conv_fwd(*fa)
    ref = C.plain_double_conv_fwd(x, *d[:6], relu_in, affine_in)
    for g, p, r, name in zip(got, plain, ref, ('y2', 'ps', 'pss')):
        _assert_bf16_accurate(g, p, r, name)
    y2 = ref[0]
    ba = (x, si, ti, w1, b1, w2, y2, dy2, dps, dpss, relu_in, affine_in)
    got = C.fused_double_conv_bwd(*ba)
    plain = C.plain_double_conv_bwd(*ba)
    ref = C.plain_double_conv_bwd(x, *d[:5], y2, dy2, *d[6:], relu_in,
                                  affine_in)
    torch.cuda.synchronize()
    # the bf16 counters moved, the fp32 ones did not
    assert (C.fused_double_conv_fwd.launches_bf16 - counts[0],
            C.fused_double_conv_bwd.launches_bf16 - counts[1],
            C.fused_double_conv_fwd.launches - counts[2],
            C.fused_double_conv_bwd.launches - counts[3]) == (1, 1, 0, 0)
    for g, p, r, name in zip(got, plain, ref, ('dx', 'dsi', 'dti', 'dw1',
                                                'db1', 'dw2', 'db2')):
        _assert_bf16_accurate(g, p, r, name)
    if not affine_in:
        assert float(got[1].abs().max() + got[2].abs().max()) == 0.0


@pytest.mark.parametrize('with_mpi', [False, True])
def test_window_gather_bf16_matches_plain(cuda, with_mpi):
    """K1 with a bfloat16 image field (``--cache_bf16``) at the recipe
    shape: still a copy, bit-identical to the plain version, counted in
    ``launches_bf16``."""
    img, aux, mpi = _levels(cuda)
    img = [t.bfloat16() for t in img]
    rng = np.random.default_rng(2)
    b, win = 64, 128
    level = np.arange(b) % 4
    hf = np.array([t.shape[1] for t in img])[level]
    wy = rng.integers(0, hf - win + 1) // 8 * 8
    wx = rng.integers(0, hf - win + 1) // 16 * 16
    scene = rng.integers(0, 4, b)
    before = (W.window_gather.launches_bf16, W.window_gather.launches)
    got = W.window_gather(img, aux, mpi, scene, level, wy, wx, win,
                          with_mpi=with_mpi)
    torch.cuda.synchronize()
    assert (W.window_gather.launches_bf16 - before[0],
            W.window_gather.launches - before[1]) == (1, 0)
    assert got[0].dtype == torch.bfloat16
    index = np.stack([scene, level, wy, wx]).astype(np.int32)
    want = W.plain_window_gather(img, aux, mpi, index, win, with_mpi)
    for g, w in zip(got, want):
        if w is None:
            assert g is None
            continue
        assert torch.equal(g, w)


@pytest.mark.parametrize('bf16', [False, True], ids=['fp32', 'bf16'])
def test_remat_on_card(cuda, bf16):
    """``--remat`` on the card, where the backward (and so each block's
    recomputation) runs on autograd's device thread: the BN running
    statistics are updated once per use of a block in the forward (a
    stream net serves two streams), not again in the recomputation, and
    with cuDNN's deterministic algorithms the gradients equal those
    without it."""
    kw = dict(model_chs=8, model_views=9, model_in_blocks=1,
              model_out_blocks=2, model_uncert=True, bf16=bf16)
    gen = torch.Generator().manual_seed(0)
    stacks = [torch.rand((2, 9, 24, 24, 3), generator=gen).to(cuda)
              for _ in range(4)]
    runs = []
    deterministic = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    try:
        for remat in (False, True):
            cfg = Config(remat=remat, **kw).finalize()
            model = init_live_(FeedForward.from_config(cfg), seed=4).to(cuda)
            model.train()
            out = model(*stacks)
            (out['mean'].abs().mean() + 0.1 * out['logvar'].mean()).backward()
            runs.append(model)
    finally:
        torch.backends.cudnn.deterministic = deterministic
    ref, model = runs
    for (name, b), c in zip(model.named_buffers(), ref.buffers()):
        if name.endswith('num_batches_tracked'):
            uses = 2 if name.startswith('in_net') else 1
            assert int(b) == int(c) == uses, name
        assert torch.equal(b, c), name
    for (name, p), q in zip(model.named_parameters(), ref.parameters()):
        assert torch.equal(p.grad, q.grad), name


# ----------------------------------------------- host runtime and U-Net


def test_host_library_mask_and_windows():
    """The port's host library (g++ at first use, under build/) against
    its numpy fallbacks on this machine: the texture mask of a random and
    of a flat scene (equal), and ``strided_window`` at f = 1..4 (equal).
    Needs g++, not a card."""
    import os
    from mmlf_tpu_torch import native
    from mmlf_tpu_torch.ops.masks import create_mask_texture

    native.reset()
    path = native.build()
    assert native.get_lib() is not None and native.loaded_path() == path
    rng = np.random.default_rng(0)
    center = rng.random((160, 144, 3), dtype=np.float32)
    center[30:90, 40:100] = 0.5
    want = create_mask_texture(center)
    os.environ[native.DISABLE_ENV] = '1'
    native.reset()
    try:
        assert native.get_lib() is None
        np.testing.assert_array_equal(create_mask_texture(center), want)
    finally:
        del os.environ[native.DISABLE_ENV]
        native.reset()
    src = rng.random((9, 131, 97, 3), dtype=np.float32)
    for f in (1, 2, 3, 4):
        got = native.strided_window(src, 2, 1, f, 20)
        np.testing.assert_array_equal(
            got, src[:, ::f, ::f][:, 2:22, 1:21])


@pytest.mark.parametrize('train', [False, True], ids=['eval', 'train'])
def test_unet_forward_on_card_matches_cpu(cuda, train):
    """``FeedForward(model_unet)`` (the full U-Net, depth 5, wf 6) on the
    card (cuDNN convs and transposed convs, TF32 off) against the CPU from
    the same weights: eval outputs within 1e-4 of their max, train-mode
    outputs (batch statistics at 3x3 at the bottom) within 1e-3."""
    cfg = Config(model_chs=8, model_views=9, model_in_blocks=1,
                 model_out_blocks=2, model_uncert=True,
                 model_unet=True).finalize()
    model = init_live_(FeedForward.from_config(cfg), seed=5).train(train)
    rng = np.random.default_rng(6)
    stacks = [torch.from_numpy(rng.random((2, 9, 48, 48, 3),
                                          dtype=np.float32))
              for _ in range(4)]
    with torch.no_grad():
        want = model(*stacks)
        got = model.to(cuda)(*[s.to(cuda) for s in stacks])
    tol = 1e-3 if train else 1e-4
    for key in ('mean', 'logvar'):
        scale = float(want[key].abs().max())
        torch.testing.assert_close(got[key].cpu(), want[key], rtol=0,
                                   atol=tol * scale, msg=key)


def test_host_pipeline_train_step_on_card_matches_cpu(cuda, tmp_path):
    """One train step on the host pipeline (accum 2): the batch sampled
    into pinned memory and copied to the card, augmented there at once;
    K1 never launches.  The loss within 1e-4 of the CPU's, and each
    gradient leaf within 1e-2 of the CPU's in relative L2 norm, and no
    further from the float64 step on the CPU than 1e-2 plus the CPU's own
    float32 distance from it: a relu' that flips on a pre-activation
    within rounding of zero moves a leaf's element by a visible share of
    its max under train-mode BatchNorm, on either device."""
    from mmlf_tpu_torch.data.hci4d import HCI4D
    from mmlf_tpu_torch.data.pipeline import TrainPipeline, batch_to_device
    from mmlf_tpu_torch.data.synth import generate_dataset
    from mmlf_tpu_torch.models.feed_forward import init_default_
    from mmlf_tpu_torch.train import loop

    root = str(tmp_path / 'data')
    generate_dataset(root, scenes=1, size=128, seed=0)
    cfg = Config(train_trainset=root, train_bs=8, train_ps=32,
                 train_lr=1e-3, train_max_downscale=2, train_accum=2,
                 model_chs=8, model_in_blocks=1, model_out_blocks=2,
                 model_uncert=True, host_pipeline=True).finalize()
    results = {}
    for name, dev, dtype in (('cpu', 'cpu', torch.float32),
                             ('f64', 'cpu', torch.float64),
                             ('card', cuda, torch.float32)):
        pipe = TrainPipeline(HCI4D(root, cache=True), cfg, seed=3)
        batch = pipe.sample_batch(8, pin_memory=name == 'card')
        pipe.close()
        if name == 'card':
            assert torch.from_numpy(batch.h).is_pinned()
        model = init_default_(FeedForward.from_config(cfg), 0).to(dev,
                                                                   dtype)
        model.dtype = dtype
        opt = loop.make_optimizer(model)
        before = W.window_gather.launches
        dev_batch = batch_to_device(batch, dev, with_mpi=False)
        dev_batch = dev_batch._replace(**{
            k: getattr(dev_batch, k).to(dtype) for k in
            ('h', 'v', 'i', 'd', 'gt')})
        loss = loop.train_step(cfg, model, opt, None, dev_batch, 5)
        assert W.window_gather.launches == before
        results[name] = (float(loss), {n: p.grad.double().cpu() for n, p in
                                       model.named_parameters()})
    (l_cpu, g_cpu), (l_gpu, g_gpu) = results['cpu'], results['card']
    g64 = results['f64'][1]
    assert abs(l_gpu - l_cpu) <= 1e-4 * abs(l_cpu)

    def l2(a, b):
        return float((a - b).norm() / b.norm().clamp_min(1e-30))

    for name in g_cpu:
        if name.endswith('.2.bias'):
            continue         # a conv bias ahead of a train-mode BN: zero
        assert l2(g_gpu[name], g_cpu[name]) <= 1e-2, (
            name, l2(g_gpu[name], g_cpu[name]), l2(g_cpu[name], g64[name]))
        assert l2(g_gpu[name], g64[name]) <= \
            1e-2 + l2(g_cpu[name], g64[name]), name


# ------------------------------------------------ probes and data parallel


@pytest.mark.parametrize('dtype', [torch.float32, torch.bfloat16],
                         ids=['fp32', 'bf16'])
@pytest.mark.parametrize('relu_out', [False, True])
@pytest.mark.parametrize('b,h,w,c', [(2, 13, 17, 24), (3, 12, 14, 70),
                                     (2, 20, 20, 280)])
def test_fused_block_kernel_matches_plain(cuda, dtype, relu_out, b, h, w, c):
    """K3's fused-block configuration (the block probe's ``fused_block``)
    against its plain version evaluated in float64 (bf16: the same rounding
    points): y1 and y2 each within 4x the float32 plain version's error,
    floored at one ulp of the output's largest magnitude in its dtype."""
    rng = np.random.default_rng(b + h + c)

    def t(a):
        return torch.from_numpy(np.asarray(a, np.float32)).to(cuda)

    x = t(rng.standard_normal((b, c, h, w)) * 0.5).to(dtype)
    p = [t(rng.standard_normal((c, c, 2, 2)) / np.sqrt(4 * c)),
         t(rng.standard_normal(c) * 0.1),
         t(rng.standard_normal((c, c, 2, 2)) / np.sqrt(4 * c)),
         t(rng.standard_normal(c) * 0.1)]
    before = (C.fused_block_fwd.launches, C.fused_block_fwd.launches_bf16)
    got = C.fused_block_fwd(x, *p, relu_out)
    torch.cuda.synchronize()
    bf16 = dtype == torch.bfloat16
    assert (C.fused_block_fwd.launches,
            C.fused_block_fwd.launches_bf16) == (before[0] + (not bf16),
                                                 before[1] + bf16)
    plain = C.plain_fused_block(x, *p, relu_out)
    ref = C.plain_fused_block(x, *(a.double() for a in p), relu_out)
    ulp = 2.0 ** (-8 if bf16 else -24)
    for name, g, pl_, r in zip(('y1', 'y2'), got, plain, ref):
        assert g.dtype == dtype and g.shape == r.shape, name
        e_k = float((g.double() - r.double()).abs().max())
        e_p = float((pl_.double() - r.double()).abs().max())
        assert e_k <= 4.0 * max(e_p, ulp * float(r.double().abs().max())), \
            (name, e_k, e_p)
    if relu_out:
        assert float(got[1].min()) >= 0.0


@pytest.mark.parametrize('c,win,ring', [(27, 120, False), (128, 128, False),
                                        (128, 128, True), (4, 33, True)])
def test_window_copy_kernels_match_plain(cuda, c, win, ring):
    """The window copies (the gather probes' ``pallas_gather`` in 16- or
    4-byte words, ``pallas_gather2``'s ring) are copies: bit-identical to
    the plain version, the 27-channel one at odd columns."""
    rng = np.random.default_rng(c + win)
    cache = torch.rand((2, 512, 512, c), device=cuda)
    scene = rng.integers(0, 2, 64)
    wy = rng.integers(0, 512 - win, 64)
    wx = rng.integers(0, 512 - win, 64) | 1
    counter = 'launches_ring' if ring else 'launches'
    before = getattr(W.window_copy, counter)
    got = W.window_copy(cache, scene, wy, wx, win, ring=ring)
    torch.cuda.synchronize()
    assert getattr(W.window_copy, counter) == before + 1
    want = W.plain_window_copy(cache, np.stack([scene, wy, wx]), win)
    assert torch.equal(got, want)
    if c % 4:
        with pytest.raises(ValueError, match='16-byte'):
            W.window_copy(cache, scene, wy, wx, win, ring=True)


def test_window_copy_ring_refuses_unaligned_pixels(cuda):
    cache = torch.zeros((2, 64, 64, 27), device=cuda)
    with pytest.raises(ValueError, match='16-byte'):
        W.window_copy(cache, [0], [0], [1], 8, ring=True)


def test_data_parallel_on_card_matches_one_rank(cuda, tmp_path):
    """``train_ranks`` with two gloo ranks sharing the card, through K1
    and K3 (``--pallas_trunk``): every rank launches on its half of each
    microbatch, and the log's losses and the BN running statistics equal
    one rank's within 1e-5 and 1e-4.  The warm start's LR is 0 at step 0,
    so both runs take step 1 from the same weights (Adam's ~lr·sign(g)
    first update would lift rounding differences in near-zero gradients
    into the second step's BN statistics)."""
    from mmlf_tpu_torch.data.synth import generate_dataset
    from mmlf_tpu_torch.train import loop

    data = str(tmp_path / 'data')
    generate_dataset(data, scenes=1, size=128, seed=0)
    stats, rows = {}, {}
    for n in (2, 1):
        out = str(tmp_path / f'run{n}')
        os.makedirs(out)
        cfg = Config(train_trainset=data, train_valset=data, train_bs=8,
                     train_ps=32, train_lr=1e-3, train_max_downscale=2,
                     train_accum=2, train_steps=2, val_interval=100,
                     train_warm_start=True,
                     model_chs=8, model_in_blocks=1, model_out_blocks=2,
                     model_uncert=True, pallas_trunk=True,
                     train_nan_guard=True, mesh_data=n).finalize()
        if n > 1:
            state = loop.train_ranks(cfg, out, n, device='cuda',
                                     backend='gloo', progress=False,
                                     timeout=300)
            for r in state.ranks:
                assert r['launches']['window_gather'] == 4
                assert r['launches']['fused_double_conv_fwd'] == 6 * 2 * 2
        else:
            state = loop.train(cfg, out, progress=False, device='cuda')
        rows[n] = [float(line.split(',')[1]) for line in
                   open(os.path.join(out, 'log.csv')).read().splitlines()[1:]]
        stats[n] = {k: v.cpu() for k, v in state.model.state_dict().items()
                    if k.endswith(('running_mean', 'running_var'))}
    np.testing.assert_allclose(rows[2], rows[1], rtol=1e-5)
    for k, want in stats[1].items():
        torch.testing.assert_close(stats[2][k], want, rtol=1e-4,
                                   atol=1e-4 * float(want.abs().max()),
                                   msg=k)


@pytest.mark.parametrize('train', [False, True], ids=['eval', 'train'])
def test_inn_forward_on_card_matches_cpu(cuda, train):
    """The INN (``--model_inn``, 1 + 2 coupling blocks, 9 views) on the
    card (cuDNN subnet convs and the permutation and distance products,
    TF32 off) against the CPU from the same seeded weights: zixels, the
    posterior and the log-det within 1e-4 of their max; the inverse of the
    card's zixels returns the stacks within 1e-4."""
    from mmlf_tpu_torch.models.inn import INN, init_inn_
    cfg = Config(model_views=9, model_in_blocks=1, model_out_blocks=2,
                 model_inn=True).finalize()
    model = init_inn_(INN.from_config(cfg), seed=3).train(train)
    rng = np.random.default_rng(4)
    stacks = [torch.from_numpy(rng.random((2, 9, 40, 44, 3),
                                          dtype=np.float32))
              for _ in range(4)]
    with torch.no_grad():
        want = model(*stacks)
        got = model.to(cuda)(*[s.to(cuda) for s in stacks])
    for key in ('zixels', 'posterior', 'jac'):
        scale = float(want[key].abs().max())
        torch.testing.assert_close(got[key].cpu(), want[key], rtol=0,
                                   atol=1e-4 * scale, msg=key)
    if not train:
        with torch.no_grad():
            back = model.inverse(got['zixels'])
        for b, s in zip(back, stacks):
            torch.testing.assert_close(b.cpu(), s, rtol=0, atol=1e-4)


def test_sharded_validation_on_card_matches_whole(cuda, tmp_path):
    """``run_validation_ranks`` with two gloo ranks sharing the card:
    ``--val_ensamble --mesh_ensemble 2`` and ``--mesh_space 2`` each launch
    K2 once a rank, and their member stacks and posterior equal the
    whole-scene run's within 1e-4."""
    from mmlf_tpu_torch.data.synth import generate_dataset
    from mmlf_tpu_torch.utils.convert import save_checkpoint_pt
    from mmlf_tpu_torch.validate.cli import (run_validation,
                                             run_validation_ranks)
    data = str(tmp_path / 'data')
    generate_dataset(data, scenes=1, size=64, seed=5)
    cfg = Config(model_chs=8, model_in_blocks=1, model_out_blocks=2,
                 model_uncert=True).finalize()
    model = init_live_(FeedForward.from_config(cfg), seed=2)
    out = {}
    for name, kw in (('whole', {}), ('ens', {'mesh_ensemble': 2}),
                     ('space', {'mesh_space': 2})):
        d = str(tmp_path / name)
        os.makedirs(d)
        save_checkpoint_pt(os.path.join(d, 'checkpoint.pt'),
                           model.state_dict(), cfg)
        if kw:
            res = run_validation_ranks(d, data, 2, device='cuda',
                                       backend='gloo', timeout=300,
                                       val_ensamble=True, **kw)
            for r in res['ranks']:
                assert r['launches']['laplace_mixture_posterior'] == 1
        else:
            run_validation(d, data, val_ensamble=True, device='cuda')
        scene = os.path.join(d, 'scenes', 'scene_00')
        out[name] = [np.load(os.path.join(scene, f))
                     for f in ('gmm.npy', 'posterior.npy')]
    for name in ('ens', 'space'):
        for got, want in zip(out[name], out['whole']):
            np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize('step', [0.05, 0.005])
def test_count_modes_on_card_matches_cpu(cuda, step):
    """gmm_cnt on the card against its CPU path, 70 members, 8192 pixels:
    the density within rtol 1e-5 (atol: the largest term whose exponential
    is denormal); every local-maximum decision that the two take apart is
    a near tie (its float64 values within 1e-5 of each other); the card's
    count_modes gives the maps of its own density, and the CPU path's maps
    equal them at every pixel without a near tie."""
    from mmlf_tpu_torch.utils import gmm_cnt as G
    rng = np.random.default_rng(0)
    k, h, w = 70, 64, 128
    gmm = np.stack([rng.normal(0, 1, (k, h, w)),
                    rng.uniform(0.5, 1.6, (k, h, w))]).astype(np.float32)
    means = torch.from_numpy(gmm[0].reshape(k, -1))
    variances = torch.from_numpy(gmm[1].reshape(k, -1))
    grid = torch.from_numpy(np.arange(-3.5, 3.5, step, dtype=np.float32))
    dens = G.mixture_on_grid(means.to(cuda), variances.to(cuda),
                             grid.to(cuda))
    dens_cpu = G.mixture_on_grid(means, variances, grid)
    vmin = float(variances.min())
    atol = float(np.finfo(np.float32).tiny) / (
        (2.0 * np.pi * vmin) ** 0.5 * vmin)
    torch.testing.assert_close(dens.cpu(), dens_cpu, rtol=1e-5, atol=atol)
    d64 = G.mixture_on_grid(means.double().to(cuda),
                            variances.double().to(cuda),
                            grid.double().to(cuda)).cpu()
    close = (d64[1:] - d64[:-1]).abs() <= \
        1e-5 * torch.maximum(d64[1:], d64[:-1])
    ties = torch.zeros_like(d64, dtype=torch.bool)
    ties[1:-1] = close[:-1] | close[1:]
    is_max = G.local_maxima(dens)
    flips = is_max.cpu() != G.local_maxima(dens_cpu)
    assert not (flips & ~ties).any()
    got = G.count_modes(gmm, -3.5, 3.5, step, device='cuda')
    for g, m in zip(got, G.mode_maps(is_max, -3.5, step)):
        np.testing.assert_array_equal(g.reshape(-1), m.cpu().numpy())
    want = G.count_modes(gmm, -3.5, 3.5, step, device='cpu')
    tied = ties.any(0).numpy().reshape(h, w)
    for g, x in zip(got, want):
        assert g.dtype == x.dtype and g.shape == x.shape
        np.testing.assert_array_equal(g[~tied], x[~tied])
