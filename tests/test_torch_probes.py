"""The probe scripts' kernels in the port (``mmlf_tpu_torch/probes``)
against the scripts: the fused block and its chain against
``scripts/pallas_block_probe.py`` (Pallas, interpret mode), and the window
copies against ``jax.vmap(jax.lax.dynamic_slice)``, the comparison
``scripts/gather_probe3.py`` and ``gather_probe4.py`` print, and against
the JAX package's window gather with one level.  The gather scripts run on
the TPU when imported, so their functions are restated here.  On the CPU
the port's wrappers take their plain versions."""

import importlib.util
import os

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from mmlf_tpu.ops.pallas.window_gather import pallas_window_gather
from mmlf_tpu_torch.ops.kernels import conv_block as C
from mmlf_tpu_torch.ops.kernels import window_gather as W
from mmlf_tpu_torch.probes import block_probe as BP
from mmlf_tpu_torch.probes import gather_probe as GP

import torch_threads  # noqa: F401  torch's share of the CPUs under xdist

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope='module')
def script():
    """``scripts/pallas_block_probe.py`` as a module (it drives only under
    ``__main__``)."""
    path = os.path.join(REPO, 'scripts', 'pallas_block_probe.py')
    spec = importlib.util.spec_from_file_location('pallas_block_probe', path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _rel(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))


def _within_ulp(got, want, rel, name):
    """bf16 values (tests/test_torch_bf16.py's rule): each within one bf16
    ulp (at most 2^-7 of its magnitude) plus ``rel`` of the largest."""
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    bound = 2.0 ** -7 * np.abs(want) + rel * np.abs(want).max()
    assert (np.abs(got - want) <= bound).all(), (name, _rel(got, want))


def _block_case(dtype, b=2, h=13, w=17, c=24, seed=0):
    """The script's check inputs (NHWC x, HWIO weights) as float32 numpy
    arrays holding values of ``dtype`` (bf16: rounded once, by JAX)."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((b, h, w, c)) * 0.5
    params = [(rng.standard_normal((2, 2, c, c)) / np.sqrt(4 * c),
               rng.standard_normal(c) * 0.1,
               rng.standard_normal((2, 2, c, c)) / np.sqrt(4 * c),
               rng.standard_normal(c) * 0.1) for _ in range(2)]

    def rnd(a):
        return np.asarray(jnp.asarray(a, dtype).astype(jnp.float32))
    return rnd(x), [tuple(rnd(a) for a in p) for p in params]


def _to_torch(a, dtype):
    return torch.from_numpy(np.array(a, np.float32)).to(dtype)


# ------------------------------------------------------------ canvas


@pytest.mark.parametrize('h,w', [(13, 17), (96, 96), (1, 1), (30, 7)])
def test_canvas_helpers_equal_the_script(script, h, w):
    assert BP.canvas_dims(h, w) == script.canvas_dims(h, w)
    rng = np.random.default_rng(h * 100 + w)
    x = rng.standard_normal((2, h, w, 3)).astype(np.float32)
    m = BP.canvas_dims(h, w)[3]
    want = np.asarray(script.to_canvas(jnp.asarray(x), m))
    got = BP.to_canvas(torch.from_numpy(x), m)
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(
        BP.from_canvas(got, h, w).numpy(),
        np.asarray(script.from_canvas(jnp.asarray(want), h, w)))
    np.testing.assert_array_equal(BP.from_canvas(got, h, w).numpy(), x)


# -------------------------------------------------------- fused block


@pytest.mark.parametrize('dtype,relu_out', [('float32', True),
                                            ('float32', False),
                                            ('bfloat16', True),
                                            ('bfloat16', False)])
def test_fused_block_matches_the_script(script, dtype, relu_out):
    """One block on the same canvas: the port's plain fused_block against
    the script's Pallas kernel (interpret mode).  y1 is compared on its
    (H+1)×(W+1) region and y2 on the interior: the rest of both canvases
    is garbage by the script's contract.  float32: 1e-5 of the largest
    magnitude; bfloat16: one bf16 ulp plus 1e-5 (the same rounding points,
    exact products, fp32 sums in another order)."""
    h, w = 13, 17
    x, params = _block_case(dtype)
    w1, b1, w2, b2 = params[0]
    jdt = jnp.dtype(dtype)
    m = BP.canvas_dims(h, w)[3]
    xc = script.to_canvas(jnp.asarray(x, jdt), m)
    jy1, jy2 = script.fused_block(xc, *(jnp.asarray(a, jdt)
                                        for a in (w1, b1, w2, b2)),
                                  h, w, relu_out=relu_out, interpret=True)
    tdt = getattr(torch, dtype)
    y1, y2 = BP.fused_block(_to_torch(np.asarray(xc.astype(jnp.float32)),
                                      tdt),
                            *(_to_torch(a, tdt) for a in (w1, b1, w2, b2)),
                            h, w, relu_out=relu_out)
    assert y1.dtype == y2.dtype == tdt
    want = BP.defined(*(torch.from_numpy(np.array(a, np.float32))
                        for a in (jy1, jy2)), h, w)
    for name, got, wnt in zip(('y1', 'y2'), BP.defined(y1, y2, h, w), want):
        g, wnt = got.float().numpy(), wnt.numpy()
        if dtype == 'float32':
            assert _rel(g, wnt) < 1e-5, name
        else:
            _within_ulp(g, wnt, 1e-5, name)
    if relu_out:
        assert float(y2.min()) >= 0.0


@pytest.mark.parametrize('dtype', ['float32', 'bfloat16'])
def test_chain_matches_the_script(script, dtype):
    """``chain_pallas`` (masked between blocks) of the port against the
    script's, and both against the direct conv chain."""
    h, w = 13, 17
    x, params = _block_case(dtype)
    jdt, tdt = jnp.dtype(dtype), getattr(torch, dtype)
    m = BP.canvas_dims(h, w)[3]
    jparams = [tuple(jnp.asarray(a, jdt) for a in p) for p in params]
    want = script.from_canvas(script.chain_pallas(
        jparams, script.to_canvas(jnp.asarray(x, jdt), m), h, w,
        interpret=True), h, w)
    tparams = [tuple(_to_torch(a, tdt) for a in p) for p in params]
    got = BP.from_canvas(BP.chain_pallas(
        tparams, BP.to_canvas(_to_torch(x, tdt), m), h, w), h, w)
    want = np.asarray(want.astype(jnp.float32))
    if dtype == 'float32':
        assert _rel(got.numpy(), want) < 1e-5
        direct = BP.chain_direct(tparams, _to_torch(x, tdt))
        assert _rel(direct.numpy(), want) < 1e-5
    else:
        _within_ulp(got.float().numpy(), want, 1e-5, 'chain')


def test_fused_block_wrapper_plain_only_on_cpu():
    """On CPU tensors ``fused_block_fwd`` is its plain version and counts
    no launch; another device raises."""
    rng = np.random.default_rng(1)
    x = torch.from_numpy(rng.standard_normal((2, 5, 6, 7)).astype(np.float32))
    w1 = torch.from_numpy(rng.standard_normal((4, 5, 2, 2)).astype(np.float32))
    w2 = torch.from_numpy(rng.standard_normal((4, 4, 2, 2)).astype(np.float32))
    b1, b2 = torch.zeros(4), torch.ones(4)
    before = (C.fused_block_fwd.launches, C.fused_block_fwd.launches_bf16)
    for dt in (torch.float32, torch.bfloat16):
        y1, y2 = C.fused_block_fwd(x.to(dt), w1, b1, w2, b2, True)
        p1, p2 = C.plain_fused_block(x.to(dt), w1, b1, w2, b2, True)
        assert y1.shape == (2, 4, 7, 8) and y2.shape == (2, 4, 6, 7)
        assert torch.equal(y1, p1) and torch.equal(y2, p2)
    assert (C.fused_block_fwd.launches,
            C.fused_block_fwd.launches_bf16) == before
    with pytest.raises(ValueError, match='device'):
        C.fused_block_fwd(*(t.to('meta') for t in (x, w1, b1, w2, b2)),
                          True)
    with pytest.raises(ValueError, match='w2'):
        C.fused_block_fwd(x, w1, b1, w1, b2, True)


# ------------------------------------------------------- window copies


def _vds(cache, scene, wy, wx, win):
    """The scripts' ``vds``: ``vmap(dynamic_slice)`` of one level."""
    c = cache.shape[-1]

    def one(s, y, x):
        return jax.lax.dynamic_slice(cache, (s, y, x, 0), (1, win, win, c))[0]
    return np.asarray(jax.jit(jax.vmap(one))(jnp.asarray(scene),
                                             jnp.asarray(wy),
                                             jnp.asarray(wx)))


def _copy_case(c, win, b, snap, seed, s=2, h=40, w=56):
    rng = np.random.default_rng(seed)
    cache = rng.random((s, h, w, c), dtype=np.float32)
    scene = rng.integers(0, s, b).astype(np.int32)
    wy = rng.integers(0, h - win + 1, b).astype(np.int32)
    wx = (rng.integers(0, (w - win) // snap + 1, b) * snap).astype(np.int32)
    return cache, scene, wy, wx


@pytest.mark.parametrize('c,win,snap', [(27, 12, 1), (128, 16, 8),
                                        (4, 9, 1), (3, 5, 1)])
def test_window_copies_equal_dynamic_slice(c, win, snap):
    """Every copy of the port (``pallas_gather``, ``pallas_gather2`` where
    the pixel is whole 16-byte words, the indexing call) equals the
    scripts' ``vmap(dynamic_slice)`` bit for bit; the 27-channel case
    takes odd columns."""
    cache, scene, wy, wx = _copy_case(c, win, 6, snap, seed=c + win)
    if snap == 1:
        wx[0] |= 1                                   # an odd column
    want = _vds(cache, scene, wy, wx, win)
    t = torch.from_numpy(cache)
    outs = [GP.pallas_gather(t, scene, wy, wx, win),
            GP.indexed_windows(t, scene, wy, wx, win),
            W.plain_window_copy(t, np.stack([scene, wy, wx]), win)]
    if c * 4 % 16 == 0:
        outs.append(GP.pallas_gather2(t, scene, wy, wx, win))
    for got in outs:
        np.testing.assert_array_equal(got.numpy(), want)


def test_window_copy_equals_the_pallas_window_gather():
    """At the 128-channel layout, one level: the copy equals the JAX
    package's window gather (its image field) in interpret mode."""
    win, s, h, w = 16, 2, 32, 64
    rng = np.random.default_rng(5)
    cache = rng.random((s, h, w, 128), dtype=np.float32)
    scene = rng.integers(0, s, 4).astype(np.int32)
    wy = (rng.integers(0, (h - win) // 8 + 1, 4) * 8).astype(np.int32)
    wx = (rng.integers(0, (w - win) // 16 + 1, 4) * 16).astype(np.int32)
    aux = np.zeros((s, h, w * 8), np.float32)
    img, _, _ = pallas_window_gather(
        (jnp.asarray(cache),), (jnp.asarray(aux),), None,
        jnp.asarray(scene), jnp.zeros(4, jnp.int32), jnp.asarray(wy),
        jnp.asarray(wx), win, with_mpi=False, interpret=True)
    t = torch.from_numpy(cache)
    for ring in (False, True):
        got = W.window_copy(t, scene, wy, wx, win, ring=ring)
        np.testing.assert_array_equal(got.numpy(), np.asarray(img))


def test_window_copy_checks_its_arguments():
    cache = torch.zeros(2, 8, 8, 4)
    before = (W.window_copy.launches, W.window_copy.launches_ring)
    assert W.window_copy(cache, [1], [0], [4], 4).shape == (1, 4, 4, 4)
    assert (W.window_copy.launches, W.window_copy.launches_ring) == before
    with pytest.raises(ValueError, match='leaves'):
        W.window_copy(cache, [0], [5], [0], 4)
    with pytest.raises(ValueError, match='scene'):
        W.window_copy(cache, [2], [0], [0], 4)
    with pytest.raises(ValueError, match='device'):
        W.window_copy(cache.to('meta'), [0], [0], [0], 4)
    with pytest.raises(ValueError, match='float32 or bfloat16'):
        W.window_copy(cache.double(), [0], [0], [0], 4)


def test_gather_probe_run_on_cpu():
    """``gather_probe.run`` checks its copies at a probe's full size (here
    on the CPU, where nothing is timed)."""
    out = GP.run('probe4', device='cpu')
    assert out['pallas_gather']['max_abs_err'] == 0.0
    assert out['pallas_gather2']['max_abs_err'] == 0.0
    assert out['bytes'] == 2 * 64 * 128 ** 2 * 128 * 4
    assert abs(out['bound_ms'] - 0.3205) < 1e-4
