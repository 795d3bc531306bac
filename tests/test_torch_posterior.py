"""Kernel K2 (Laplace-mixture posterior): the port's plain version against
the Pallas kernel in interpret mode, at the shapes and tolerance of
tests/test_pallas.py.  The CUDA kernel itself is held against the plain
version in tests/test_torch_cuda.py, on a card; its float32 arithmetic
(the polynomial exp2 and the share of bins that takes it) is emulated
here."""

import os
import re

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from mmlf_tpu.ops.pallas import posterior as jP
from mmlf_tpu_torch.ops.kernels import posterior as tP

import torch_threads  # noqa: F401  torch's share of the CPUs under xdist


def _inputs(rng, k, p, kb):
    means = rng.uniform(-3, 3, (k, p)).astype(np.float32)
    scales = rng.uniform(0.2, 2.0, (k, p)).astype(np.float32)
    bins = np.linspace(-3.5, 3.5, kb).astype(np.float32)
    return means, scales, bins


@pytest.mark.parametrize('case', [
    ('mixture', 7, 300, 11),      # p deliberately not a tile multiple
    ('mixture', 70, 257, 70),     # the ESE member/bin count
    ('ensemble', 5, (1, 6, 8)),
    ('ensemble', 70, (1, 9, 7)),
])
def test_plain_posterior_matches_pallas(case):
    rng = np.random.default_rng(len(str(case)))
    if case[0] == 'mixture':
        _, k, p, kb = case
        means, scales, bins = _inputs(rng, k, p, kb)
        got = tP.laplace_mixture_posterior(
            torch.from_numpy(means), torch.from_numpy(scales),
            torch.from_numpy(bins)).numpy()
        want = np.asarray(jP.laplace_mixture_posterior(
            jnp.asarray(means), jnp.asarray(scales), jnp.asarray(bins),
            interpret=True))
        assert got.shape == (p, kb)
        np.testing.assert_allclose(got, want.T, rtol=2e-5, atol=1e-6)
    else:
        _, k, spatial = case
        means = rng.uniform(-2, 2, (k,) + spatial).astype(np.float32)
        logvars = rng.uniform(-1, 0.5, (k,) + spatial).astype(np.float32)
        got = tP.ensemble_posterior(torch.from_numpy(means),
                                    torch.from_numpy(logvars),
                                    -3.5, 3.5).numpy()
        want = np.asarray(jP.ensemble_posterior(
            jnp.asarray(means), jnp.asarray(logvars), -3.5, 3.5,
            interpret=True))
        assert got.shape == spatial + (k,)
        np.testing.assert_allclose(got, want, rtol=2e-5, atol=1e-6)


# --- K2's arithmetic on the card, emulated in float32 numpy -----------------
# csrc/exp2_poly.cuh holds the polynomial exp2 that takes a share of the
# kernel's exponentials off the special-function units; csrc/posterior.cu
# fixes which of a thread's bin slots take it.  The card cannot be asked
# here, so these tests read both sources and emulate the arithmetic.

CSRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))), 'mmlf_tpu_torch', 'csrc')


def _cuh_constants():
    with open(os.path.join(CSRC, 'exp2_poly.cuh')) as fh:
        text = fh.read()
    consts = {name: float.fromhex(value) if 'x' in value else float(value)
              for name, value in re.findall(
                  r'constexpr float (EXP2_\w+) = ([-+0-9a-fx.p]+)f;', text)}
    coeffs = np.array([consts[f'EXP2_P{i}'] for i in range(6)], np.float32)
    assert consts['EXP2_ROUND'] == 1.5 * 2 ** 23
    return coeffs, np.float32(consts['EXP2_POLY_MIN']), \
        np.float32(consts['EXP2_ROUND'])


def _fmaf(a, b, c):
    """float32 fmaf: the float32 product is exact in float64; the sum is
    rounded there, then to float32 (a true FMA rounds once; the two differ
    only in rare half-way cases, by at most one float32 ulp)."""
    return (np.float64(a) * np.float64(b) + np.float64(c)).astype(np.float32)


def exp2_poly(x):
    """``mmlf::exp2_poly`` of exp2_poly.cuh in float32 numpy: clamp, split
    with the 1.5·2^23 add, degree-5 Horner, the integer added to the
    exponent bits."""
    coeffs, lo, rnd = _cuh_constants()
    x = np.maximum(np.asarray(x, np.float32), lo)
    j = (x + rnd).astype(np.float32)
    f = (x - (j - rnd).astype(np.float32)).astype(np.float32)
    p = _fmaf(coeffs[5], f, coeffs[4])
    for c in coeffs[3::-1]:
        p = _fmaf(p, f, c)
    bits = p.view(np.uint32) + (j.view(np.uint32) << np.uint32(23))
    return bits.view(np.float32)


def test_exp2_poly_relative_error():
    """Against float64 2**x over the arguments the kernel sees, [-126, 0]:
    every fraction f = x - round(x) of a fine grid, at several integer
    parts, and random arguments; the bound the header states, 1.85e-7,
    within 2e-7."""
    rng = np.random.default_rng(0)
    f = np.linspace(-0.5, 0.5, 400_001)
    x = np.concatenate([
        (f[None] + np.array([0.0, -1.0, -17.0, -125.0])[:, None]).ravel(),
        -rng.uniform(0.0, 126.0, 1_000_000), [-126.0, 0.0, -0.5, -125.5]])
    x = x[x <= 0].astype(np.float32)
    got = exp2_poly(x).astype(np.float64)
    want = np.exp2(x.astype(np.float64))
    assert np.all(np.isfinite(got)) and np.all(got > 0)
    rel = np.abs(got / want - 1.0)
    assert rel.max() <= 2e-7, (rel.max(), x[rel.argmax()])
    # below the clamp the result is the smallest normal, never garbage
    assert exp2_poly(np.float32([-127.0, -1e4]))[0] == np.float32(2.0 ** -126)


def _poly_every():
    """Bin slot i of a thread takes exp2_poly when i % this == this - 1
    (``POLY_EVERY`` of csrc/posterior.cu)."""
    with open(os.path.join(CSRC, 'posterior.cu')) as fh:
        return int(re.search(r'constexpr int POLY_EVERY = (\d+);',
                             fh.read()).group(1))


def _kernel_emulated(means, scales, bins):
    """The kernel's arithmetic term by term in float32: staged s and c,
    the argument |bin - m| * s, the bin slots that ``POLY_EVERY`` picks
    through ``exp2_poly``, the others through a correctly rounded exp2
    (ex2.approx is ~2 ulp), fmaf into the sum, times 1/K."""
    k, _ = means.shape
    every = _poly_every()
    bpt = min(16, -(-len(bins) // 8))   # bins per thread and pass, 8 warps
    rv = (np.float32(1.0) / scales).astype(np.float32)
    s = (np.float32(-1.4426950408889634) * rv).astype(np.float32)
    c = (np.float32(0.5) * rv).astype(np.float32)
    out = np.zeros((means.shape[1], len(bins)), np.float32)
    for j, b in enumerate(bins):
        slot = (j % (8 * bpt)) // 8     # bin j's slot within its pass
        poly = slot % every == every - 1
        acc = np.zeros(means.shape[1], np.float32)
        for kk in range(k):
            x = (np.abs((b - means[kk]).astype(np.float32))
                 * s[kk]).astype(np.float32)
            e = exp2_poly(x) if poly else \
                np.exp2(x.astype(np.float64)).astype(np.float32)
            acc = _fmaf(c[kk], e, acc)
        out[:, j] = acc * np.float32(1.0 / k)
    return out


@pytest.mark.parametrize('k,p', [(70, 2000), (141, 400)],
                         ids=['disp_step_0.1', 'disp_step_0.05'])
def test_kernel_arithmetic_vs_plain_fp32(k, p):
    """The accuracy rule the card holds K2 to, on its emulated arithmetic:
    the error against float64 within 4x the fp32 plain version's, at the
    ESE's default K = Kb = 70 (9 bins a thread, one pass) and at
    --val_disp_step 0.05's K = Kb = 141 (16 bins a thread, two passes)."""
    rng = np.random.default_rng(3)
    means = rng.uniform(-3.5, 3.5, (k, p)).astype(np.float32)
    scales = np.exp(rng.uniform(-3.0, 1.0, (k, p))).astype(np.float32)
    bins = np.linspace(-3.5, 3.5, k).astype(np.float32)
    assert _poly_every() > 1
    ref = tP.plain_mixture_posterior(*(torch.from_numpy(a).double() for a in
                                       (means, scales, bins))).numpy()
    plain = tP.plain_mixture_posterior(*(torch.from_numpy(a) for a in
                                         (means, scales, bins))).numpy()
    got = _kernel_emulated(means, scales, bins)
    e_k, e_p = np.abs(got - ref).max(), np.abs(plain - ref).max()
    assert e_k <= 4.0 * max(e_p, 2.0 ** -24 * np.abs(ref).max()), (e_k, e_p)
