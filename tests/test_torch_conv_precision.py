"""The numerical argument behind kernel K3's 3×TF32 products, on the CPU.

K3 (``mmlf_tpu_torch/csrc/conv_block.cu``) runs every GEMM of a trunk block
on the tensor cores in TF32 and keeps fp32's accuracy by splitting each
operand ``a = hi + lo`` with ``hi = tf32(a)``, ``lo = tf32(a − hi)``
(``cvt.rna.tf32.f32``) and summing ``lo·hi' + hi·lo' + hi·hi'``.  Here the
split is emulated with bit operations (10 mantissa bits, round to nearest,
ties away from zero) and held against float64 at the out_net's depth
K = 4·280 = 1120; the card tests (``tests/test_torch_cuda.py``) then hold the
kernel itself to the same bound.  Also the layout contract of the kernel's
GEMM weights and the build digest.
"""

import numpy as np
import pytest
import torch
from torch.nn import functional as F

from mmlf_tpu_torch.ops.kernels import build
from mmlf_tpu_torch.ops.kernels import conv_block as C

import torch_threads  # noqa: F401  torch's share of the CPUs under xdist

K = 4 * 280          # GEMM depth of an out_net conv (4 taps × 280 channels)
STAGE = 16           # depth of one stage's chain in the tensor core
FACTOR = 4.0         # the bound the card test holds K3 to


def tf32(a: torch.Tensor) -> torch.Tensor:
    """``cvt.rna.tf32.f32``: keep 10 of fp32's 23 mantissa bits, rounding
    to nearest with ties away from zero (on the magnitude bits, so both
    signs round away)."""
    bits = a.contiguous().view(torch.int32)
    return ((bits + 0x1000) & ~0x1FFF).view(torch.float32)


def split(a: torch.Tensor):
    hi = tf32(a)
    return hi, tf32(a - hi)


def staged_dot(terms, k: int) -> torch.Tensor:
    """Σ over ``terms`` of x @ y as the kernel sums it: each product exact
    (TF32 × TF32 fits in fp32's significand), each 16-deep stage's sum
    rounded to fp32, the stages added into an fp32 accumulator."""
    acc = None
    for s in range(0, k, STAGE):
        part = sum(x[:, s:s + STAGE].double() @ y[s:s + STAGE].double()
                   for x, y in terms).float()
        acc = part if acc is None else acc + part
    return acc


def _operands(seed: int, relu: bool):
    rng = np.random.default_rng(seed)
    a = rng.standard_normal((128, K)).astype(np.float32)
    if relu:                  # post-ReLU activations: one-signed sums
        a = np.maximum(a, 0.0) + 0.05
    w = (rng.standard_normal((K, 48)) / np.sqrt(K)).astype(np.float32)
    return torch.from_numpy(a), torch.from_numpy(w)


def test_tf32_rounding_emulation():
    one = 1.0 + 2.0 ** -10                     # exact in TF32
    half_ulp = 2.0 ** -11
    x = torch.tensor([one, 1.0 + half_ulp, -(1.0 + half_ulp),
                      1.0 + half_ulp - 2.0 ** -20, 3.0e-3, 0.0],
                     dtype=torch.float32)
    got = tf32(x)
    assert got[0] == one
    assert got[1] == one and got[2] == -one    # ties away from zero
    assert got[3] == 1.0                       # below the tie: down
    assert got[5] == 0.0
    # 10 mantissa bits kept, 13 cleared
    assert int((got.view(torch.int32) & 0x1FFF).abs().max()) == 0
    rel = ((got[4] - x[4]) / x[4]).abs()
    assert float(rel) <= 2.0 ** -11


@pytest.mark.parametrize('relu', [False, True], ids=['signed', 'relu'])
def test_split_product_keeps_fp32_accuracy(relu):
    """At K = 1120: the 3×TF32 dot product's error against float64 is within
    4× of fp32's, one TF32 product's is not (it misses by ~500×)."""
    a, w = _operands(seed=int(relu), relu=relu)
    ref = a.double() @ w.double()
    err_fp32 = float((a @ w - ref).abs().max())
    (ah, al), (wh, wl) = split(a), split(w)
    three = staged_dot([(al, wh), (ah, wl), (ah, wh)], K)
    one = staged_dot([(ah, wh)], K)
    err_three = float((three.double() - ref).abs().max())
    err_one = float((one.double() - ref).abs().max())
    assert err_three <= FACTOR * err_fp32, (err_three, err_fp32)
    assert err_one > 25 * FACTOR * err_fp32, (err_one, err_fp32)


def test_split_is_exact_to_22_bits():
    """hi + lo reproduces every operand to within 2^-22 of its magnitude,
    and hi, lo are TF32 values (13 low mantissa bits clear)."""
    a, _ = _operands(seed=2, relu=False)
    hi, lo = split(a)
    for part in (hi, lo):
        assert int((part.view(torch.int32) & 0x1FFF).abs().max()) == 0
    rel = ((hi.double() + lo.double() - a.double()).abs()
           / a.double().abs().clamp_min(1e-30))
    assert float(rel.max()) <= 2.0 ** -22


def test_gemm_weights_are_k_major_oihw():
    """The kernel reads its weights as (N, 4·Cin) with k = ci·4 + tap (tap =
    dy·2 + dx), and the dgrad weights so that a pad-1 ↔ pad-0 conv with them
    is the input gradient."""
    rng = np.random.default_rng(3)
    w = torch.from_numpy(rng.standard_normal((5, 3, 2, 2)).astype(np.float32))
    g = C._gemm_weight(w)
    assert g.shape == (5, 12) and g.is_contiguous()
    for n, ci, dy, dx in ((4, 2, 1, 0), (0, 1, 0, 1), (3, 0, 1, 1)):
        assert g[n, ci * 4 + dy * 2 + dx] == w[n, ci, dy, dx]
    dg = C._dgrad_weight(w)
    assert dg.shape == (3, 20)
    dy1 = torch.from_numpy(rng.standard_normal((2, 5, 7, 9)).astype(
        np.float32))
    want = torch.nn.grad.conv2d_input((2, 3, 6, 8), w, dy1, padding=1)
    got = F.conv2d(dy1, dg.reshape(3, 5, 2, 2))
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)


def test_library_digest_covers_headers(tmp_path, monkeypatch):
    """A header beside the sources changes every library's digest, so an
    edited header never loads a stale build."""
    (tmp_path / 'k.cu').write_text('// kernel\n')
    monkeypatch.setattr(build, 'CSRC_DIR', tmp_path)
    before = build.library_path('k')
    (tmp_path / 'common.cuh').write_text('// v1\n')
    with_header = build.library_path('k')
    (tmp_path / 'common.cuh').write_text('// v2\n')
    edited = build.library_path('k')
    assert len({before, with_header, edited}) == 3
    (tmp_path / 'notes.txt').write_text('not a header')
    assert build.library_path('k') == edited
