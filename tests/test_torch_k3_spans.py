"""The span rule of K3's bfloat16 conv GEMMs, restated in numpy.

``mmlf_tpu_torch/csrc/conv_block.cu`` feeds every bf16 ``conv2x2_kernel``
launch (y1, y2, dgrad2, dgrad1) from channel spans: a block's TM output
pixels are consecutive in (b, oy, ox), so in each image they touch the
in-image 2x2 taps of one input channel lie in one run of the channel
plane, ``[max(0, base(first)), min(hw, base(last) + win + 2))`` with
``base(oy, ox) = (oy - pad) * win + ox - pad``.  Each run is widened to
16-byte chunks and bulk-copied into the slot's region for the channel, at
``run_cap(run 0) + (r - 1) * run_cap(hw)`` for run r > 0; a region holds
``span_elems`` elements.  The kernel cannot run here, so this walks every
tile of the recipe's launches (and of the ragged and single-image shapes
the card tests use) and checks the rule the kernel's comment states:
every in-image tap of every valid pixel lies in its run and is found where
the transform reads it, every run is 16-byte aligned and fits its slot,
no run leaves the 16-byte padded allocation, and a tile spans at most two
images.  It also checks that the transform's unmasked loads stay in shared
memory and that the shared memory of each launch fits the card.
"""

import re
from pathlib import Path

import numpy as np
import pytest

SRC = Path(__file__).resolve().parents[1] / 'mmlf_tpu_torch' / 'csrc' / \
    'conv_block.cu'
# the card's opt-in shared memory a block (H100: 227 KB)
SMEM_LIMIT = 232448


def _constant(name: str) -> int:
    m = re.search(rf'constexpr int {name} = (\d+);', SRC.read_text())
    assert m, name
    return int(m.group(1))


STAGES, NBUF = _constant('STAGES'), _constant('NBUF')
CPS = 8                        # channels a 32-deep bf16 stage


def run_cap(n):
    """Slot room of a run of n elements copied in whole 16-byte chunks."""
    return (n + 14) & ~7


def span_elems(tm, b, hin, win, pad):
    """A channel region's elements (the kernel's ``span_elems``)."""
    wo, ho = win + 2 * pad - 1, hin + 2 * pad - 1
    hwo, hw = ho * wo, hin * win
    nimg = min(b, (tm - 1 + hwo - 1) // hwo + 1)
    need = tm + nimg * (win + 1)
    if pad == 0:
        need += -(-tm // wo) + nimg
    need = min(need, nimg * hw)
    return -(-(need + 14 * nimg) // 8) * 8


def tile_rows(n_out):
    """TM of the bf16 conv tile for n_out output channels (``SpanTiles``:
    the narrow tiles take 256 rows)."""
    return 256 if n_out <= 72 else 128


def tile_cols(n_out):
    """TN: wider outputs than 112 channels take 144-column tiles."""
    return next((t for t in (8, 32, 72, 112) if n_out <= t), 144)


def span_smem(tm, tn, span, cin, win):
    """Dynamic shared memory of one launch (``SpanCfg::smem``, the room
    for the unmasked tap loads past the ring, si and ti)."""
    op = (tm + tn) * 16                          # 32-bit words a buffer
    main = 4 * NBUF * op + STAGES * 2 * CPS * span
    epi = 4 * tn * (tm + 4)
    return max(main, epi) + 8 * (STAGES + NBUF) + 2 * (win + 8) + \
        8 * cin


def tap_base(r, wo, win, pad):
    oy = r // wo
    return (oy - pad) * win + (r - oy * wo) - pad


def check_launch(b, cin, hin, win, pad, n_out):
    """Walk every tile of one bf16 conv2x2 launch; returns the most
    images a tile touched."""
    tm = tile_rows(n_out)
    wo, ho = win + 2 * pad - 1, hin + 2 * pad - 1
    hwo, hw = ho * wo, hin * win
    m_total = b * hwo
    total = b * cin * hw                         # x's elements
    alloc = -(-total // 8) * 8                   # padded to 16 bytes
    span = span_elems(tm, b, hin, win, pad)
    assert span_smem(tm, tile_cols(n_out), span, cin, win) <= SMEM_LIMIT

    # the tile's runs (SpanLoader::at)
    m0 = np.arange(0, m_total, tm, dtype=np.int64)
    m_last = np.minimum(m0 + tm, m_total) - 1
    b0, bl = m0 // hwo, m_last // hwo
    nr = bl - b0 + 1
    lo0 = np.maximum(tap_base(m0 - b0 * hwo, wo, win, pad), 0)
    hi_last = np.minimum(tap_base(m_last - bl * hwo, wo, win, pad) + win + 2,
                         hw)
    len0 = np.where(nr == 1, hi_last, hw) - lo0
    assert (len0 > 0).all() and (hi_last > 0).all()

    # every run of every channel: aligned, inside its region and the
    # allocation, and never out of its plane before the chunking
    ci = np.arange(cin, dtype=np.int64)
    for r in range(int(nr.max())):
        has = nr > r
        lo = np.where(r == 0, lo0, 0)[has]
        hi = np.where(r == nr - 1, hi_last, hw)[has]
        assert (0 <= lo).all() and (lo < hi).all() and (hi <= hw).all()
        at = np.where(r == 0, 0, run_cap(len0) + (r - 1) * run_cap(hw))[has]
        p = ((b0[has] + r)[:, None] * cin + ci[None]) * hw
        s = (p + lo[:, None]) & ~7
        e = (p + hi[:, None] + 7) & ~7
        assert (s % 8 == 0).all() and (e % 8 == 0).all()    # 16-byte chunks
        assert (s >= 0).all() and (e <= alloc).all()
        assert ((e - s) <= run_cap(hi - lo)[:, None]).all()
        assert (at[:, None] + (e - s) <= span).all()

    # every in-image tap of every valid pixel: in its run, and where the
    # transform reads it (d + (q + ci hw) % 8 + tap offset, in region c)
    m = np.arange(m_total, dtype=np.int64)
    t = m // tm
    bb, r = m // hwo, m % hwo
    rr = bb - b0[t]
    lo = np.where(rr == 0, lo0[t], 0)
    hi = np.where(rr == nr[t] - 1, hi_last[t], hw)
    at = np.where(rr == 0, 0, run_cap(len0[t]) + (rr - 1) * run_cap(hw))
    base = tap_base(r, wo, win, pad)
    d = at + base - lo
    q = bb * cin * hw + lo
    oy, ox = r // wo, r % wo
    # the unmasked loads of every tap, in or out of the image, of any
    # channel: no further than win + 1 elements before the channel's region
    # (into the operand buffers before the ring) or win + 8 past it (into
    # the next region, or the room the launch leaves past the ring)
    op_bytes = 4 * NBUF * (tm + tile_cols(n_out)) * 16
    assert 2 * (win + 1) <= op_bytes
    assert (d >= -(win + 1)).all() and (d + 7 + win + 1 < span + win + 8).all()
    rng = np.random.default_rng(cin + hin + pad)
    channels = sorted({0, cin - 1, *rng.integers(0, cin, 3).tolist()})
    for dy in (0, 1):
        for dx in (0, 1):
            iy, ix = oy - pad + dy, ox - pad + dx
            inside = (iy >= 0) & (iy < hin) & (ix >= 0) & (ix < win)
            local = base + dy * win + dx
            assert ((lo <= local) & (local < hi))[inside].all()
            for c in channels:
                g = (bb * cin + c) * hw + local          # x's element
                s = ((bb * cin + c) * hw + lo) & ~7
                pos = d + ((q + c * hw) & 7) + dy * win + dx
                want = at + g - s
                assert (pos == want)[inside].all()
                assert ((0 <= pos) & (pos < span))[inside].all()
    return int(nr.max())


def _launches(b, cin, h, w, cout):
    """The block's bf16 conv2x2 launches: (x's channels, Hin, Win, pad,
    N): y1 (forward, and again in the backward), y2, dgrad2, dgrad1."""
    return {'y1': (cin, h, w, 1, cout), 'y2': (cout, h + 1, w + 1, 0, cout),
            'dgrad2': (cout, h, w, 1, cout),
            'dgrad1': (cout, h + 1, w + 1, 0, cin)}


BLOCKS = [(27, 70), (70, 70), (280, 280), (280, 2), (280, 108)]
CASES = [((64, 96, 96), blk) for blk in BLOCKS] + \
    [((3, 13, 17), blk) for blk in BLOCKS] + \
    [((1, 96, 96), (280, 280)), ((1, 96, 96), (70, 70))]


@pytest.mark.parametrize('launch', ['y1', 'y2', 'dgrad2', 'dgrad1'])
@pytest.mark.parametrize('size,block', CASES,
                         ids=[f'B{s[0]}_{s[1]}x{s[2]}_{c[0]}to{c[1]}'
                              for s, c in CASES])
def test_span_rule_covers_every_tap(size, block, launch):
    b, h, w = size
    cin, hin, win, pad, n_out = _launches(b, block[0], h, w, block[1])[launch]
    assert check_launch(b, cin, hin, win, pad, n_out) <= 2


def test_span_elems_at_the_recipe():
    """The recipe's regions: ~TM + win elements, well under the word
    ring's 16.5 KB a stage that left room for 128-row tiles only."""
    assert span_elems(128, 64, 96, 96, 1) == 352
    assert span_elems(128, 64, 97, 97, 0) == 360
    assert span_elems(256, 64, 97, 97, 0) == 488
    for tm, hin, pad in ((128, 96, 1), (128, 97, 0), (256, 96, 1),
                         (256, 97, 0)):
        assert 2 * CPS * span_elems(tm, 64, hin, hin, pad) <= 8 * 1024


def test_many_images_a_tile():
    """Images smaller than a tile: the rule still holds, with a run per
    image (the middle ones whole planes)."""
    assert check_launch(40, 8, 3, 4, 0, 8) > 2
    assert check_launch(40, 8, 2, 3, 1, 70) > 2


def _bf16_round(x):
    """float64 values (each exactly a sum or product of two bf16 values,
    or its float32 rounding) rounded to bfloat16, to nearest, ties to
    even, as float64."""
    m, e = np.frexp(x)
    return np.ldexp(np.round(np.ldexp(m, 8)), e - 8)


@pytest.mark.parametrize('op', ['mul', 'add'])
def test_bf16_pair_ops_round_as_fp32(op):
    """The span transform's input stage runs mul.rn / add.rn .bf16x2, which
    round the exact result once; PR 7's rounded the float32 result.  For
    bf16 operands the two agree: a float32 product is exact, and a float32
    sum that rounds at all lies far from any bf16 rounding boundary.
    Random normal bf16 pairs, half of them with exponents within 40 of
    each other (where float32 sums round)."""
    rng = np.random.default_rng(0 if op == 'mul' else 1)
    n = 1 << 20
    bits = rng.integers(0, 1 << 16, (2, n), dtype=np.uint32)
    exp = (bits >> 7) & 0xFF
    bits[1, n // 2:] = (bits[1, n // 2:] & 0x807F) | (
        np.clip(exp[0, n // 2:].astype(np.int64) +
                rng.integers(-40, 41, n - n // 2), 1, 254).astype(np.uint32)
        << 7)
    ok = ((bits >> 7) & 0xFF > 0) & ((bits >> 7) & 0xFF < 255)
    a, b = ((bits << 16).view(np.float32)[:, ok.all(0)])
    exact = a.astype(np.float64) * b if op == 'mul' else \
        a.astype(np.float64) + b
    with np.errstate(over='ignore'):
        f32 = (a * b) if op == 'mul' else (a + b)
    keep = np.isfinite(f32) & (np.abs(exact) > 2.0 ** -126) & \
        (np.abs(exact) < 2.0 ** 127)
    once = _bf16_round(exact[keep])
    twice = _bf16_round(f32[keep].astype(np.float64))
    assert keep.sum() > n // 2
    np.testing.assert_array_equal(once, twice)
