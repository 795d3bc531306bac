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

import torch_threads  # noqa: F401  torch's share of the CPUs under xdist

SRC = Path(__file__).resolve().parents[1] / 'mmlf_tpu_torch' / 'csrc' / \
    'conv_block.cu'
# the card's opt-in shared memory a block (H100: 227 KB)
SMEM_LIMIT = 232448


def _constant(name: str) -> int:
    m = re.search(rf'constexpr int {name} = (\d+);', SRC.read_text())
    assert m, name
    return int(m.group(1))


def _instance(name: str, key: str) -> int:
    """A constant of one of the kernel's instances (``struct Bf16``,
    ``struct Tf32x3``)."""
    body = re.search(rf'struct {name} {{(.*?)\n}};', SRC.read_text(), re.S)
    assert body, name
    m = re.search(rf'\b{key} = (\d+)', body.group(1))
    assert m, (name, key)
    return int(m.group(1))


STAGES = _constant('STAGES')
NBUF = _instance('Bf16', 'NBUF')   # operand buffers of the bf16 instance
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


# ---- the weight gradients' spans ----------------------------------------
#
# Both bf16 ``wgrad_kernel`` launches of a block (dW2 = sum g2 (x) taps(y1),
# pad 0; dW1 = sum dy1 (x) taps(z), pad 1) read spans too
# (``WgradSpanLoader``): A's rows are the im2col columns (ci, tap) of the
# tile's 32 x channels, B's the gradient's output channels, and k the 32
# pixels of a stage.  The copies go by groups of WGRAD_GROUP stages: a
# group's taps of one x channel lie in one run of its plane per image (the
# rule above for the group's pixels), and its gradient values of one
# channel in one run of that channel's plane.  The kernel's pixel table
# gives each pixel's offset in an x region and a gradient region; a
# channel adds its part of the chunk shift.  Restated here with the
# kernel's arithmetic, over every group of every chunk of the launches.

def _source_value(name: str) -> int:
    m = re.search(rf'constexpr (?:int|long long) {name} = ([\d *]+);',
                  SRC.read_text())
    assert m, name
    return int(np.prod([int(v) for v in m.group(1).split('*')]))


WGRAD_TARGET_BLOCKS = _source_value('WGRAD_TARGET_BLOCKS')
WGRAD_MAX_CHUNK = _source_value('WGRAD_MAX_CHUNK')
WGRAD_GROUP = _source_value('WGRAD_GROUP')
BK = 32                        # pixels a bf16 stage
PIX = WGRAD_GROUP * BK         # pixels a copy group
WGRAD_TM = 128                 # x channels (4 taps each) of a wgrad tile
CA = WGRAD_TM // 4


def _cdiv(a, b):
    return -(-a // b)


def wgrad_chunks(b, cin, hin, win, n_out, pad):
    """``(chunk length, count)`` of the kernel's ``wgrad_chunks``."""
    m = b * (hin + 2 * pad - 1) * (win + 2 * pad - 1)
    tiles = _cdiv(4 * cin, WGRAD_TM) * _cdiv(n_out, tile_cols(n_out))
    want = max(_cdiv(WGRAD_TARGET_BLOCKS, tiles), _cdiv(m, WGRAD_MAX_CHUNK))
    want = max(min(want, _cdiv(m, 16 * BK)), 1)
    length = _cdiv(_cdiv(m, want), BK) * BK
    return length, _cdiv(m, length)


def wgrad_images(b, hwo, length):
    """Images a copy group touches at most (``wgrad_images``)."""
    g = int(np.gcd(np.gcd(length, PIX), hwo))
    return min((hwo - g + PIX - 1) // hwo + 1, b)


def wgrad_span_a(b, hin, win, pad, length):
    wo, ho = win + 2 * pad - 1, hin + 2 * pad - 1
    nimg = wgrad_images(b, ho * wo, length)
    need = PIX + (1 if pad else nimg) * (win + 1)
    if not pad:
        need += _cdiv(PIX, wo) + nimg
    return _cdiv(min(need, nimg * hin * win) + 14 * nimg, 8) * 8


def wgrad_span_b(b, hwo, length):
    nimg = wgrad_images(b, hwo, length)
    need = min(PIX, nimg * hwo) + 14 * nimg
    return 32 if need <= 32 else 32 + _cdiv(need - 32, 64) * 64


def wgrad_smem(tn, span_a, span_b, cin, win):
    """Dynamic shared memory of one launch (``WgradSpanCfg::smem`` and
    si, ti)."""
    op = (WGRAD_TM + tn) * 16
    ring = 4 * (CA * span_a + tn * span_b)
    main = 4 * NBUF * op + ring + ((2 * (win + 8) + 15) & ~15)
    epi = 4 * tn * (WGRAD_TM + 4)
    return max(main, epi) + 2 * 16 * PIX + 2 * 8 + 8 * cin


def wgrad_groups(b, cin, hin, win, pad, n_out):
    """Every copy group of every chunk of one launch, as the kernel plans
    it: per group its first image, run count, x runs' (lo, hi, slot room
    of run 0) and gradient runs' likewise; per group and pixel the pixel
    (image, plane offsets) and its table entry."""
    wo, ho = win + 2 * pad - 1, hin + 2 * pad - 1
    hwo, hw = ho * wo, hin * win
    m_total = b * hwo
    length, count = wgrad_chunks(b, cin, hin, win, n_out, pad)
    assert length % BK == 0
    starts, ends = [], []
    for z in range(count):
        m_begin, m_end = z * length, min(m_total, (z + 1) * length)
        s = np.arange(m_begin, m_end, PIX)
        starts.append(s)
        ends.append(np.full_like(s, m_end))
    m = np.concatenate(starts)[:, None] + np.arange(PIX)[None]
    valid = m < np.concatenate(ends)[:, None]
    bb, r = m // hwo, m % hwo
    oy, ox = r // wo, r % wo
    tb = (oy - pad) * win + ox - pad
    last = valid.sum(1) - 1
    rows = np.arange(len(m))
    b0 = bb[:, 0]
    nr = bb[rows, last] - b0 + 1
    lo_a = np.maximum(tb[:, 0], 0)
    hi_a = np.minimum(tb[rows, last] + win + 2, hw)
    cap_a = run_cap(np.where(nr == 1, hi_a, hw) - lo_a)
    r0 = r[:, 0]
    hi_g = r[rows, last] + 1
    cap_g = run_cap(np.where(nr == 1, hi_g, hwo) - r0)
    rr = bb - b0[:, None]
    la = np.where(rr == 0, lo_a[:, None], 0)
    lg = np.where(rr == 0, r0[:, None], 0)
    da = np.where(rr == 0, 0, cap_a[:, None] + (rr - 1) * run_cap(hw)) + \
        tb - la
    dg = np.where(rr == 0, 0, cap_g[:, None] + (rr - 1) * run_cap(hwo)) + \
        r - lg
    return dict(m=m, valid=valid, b=bb, r=r, oy=oy, ox=ox, tb=tb, b0=b0,
                nr=nr, lo_a=lo_a, hi_a=hi_a, cap_a=cap_a, r0=r0, hi_g=hi_g,
                cap_g=cap_g, la=la, lg=lg, da=np.where(valid, da, 0),
                dg=np.where(valid, dg, 0), qa=(bb * cin * hw + la) & 7,
                qg=(bb * n_out * hwo + lg) & 7, length=length)


def _runs(st, rr, channels, n_chan, plane, lo, hi, cap0):
    """The runs rr of the given channels of every group that has one:
    ``(s, e, dst, lo, hi)``, chunked start and end in the tensor, the
    place in the channel's region and the run before chunking."""
    has = st['nr'] > rr
    lo_r = np.where(rr == 0, lo, 0)[has]
    hi_r = np.where(rr == st['nr'] - 1, hi, plane)[has]
    assert (0 <= lo_r).all() and (lo_r < hi_r).all() and \
        (hi_r <= plane).all()                       # runs stay in the plane
    p = ((st['b0'][has] + rr)[:, None] * n_chan + channels[None]) * plane
    s = (p + lo_r[:, None]) & ~7
    e = (p + hi_r[:, None] + 7) & ~7
    dst = np.where(rr == 0, 0, cap0 + (rr - 1) * run_cap(plane))[has]
    return s, e, dst[:, None], lo_r, hi_r


def check_wgrad_launch(b, cin, hin, win, pad, n_out):
    """Walk every copy group of every chunk of one bf16 wgrad launch (x
    with cin channels of hin x win, the conv's pad, n_out gradient
    channels) and check the span rule; returns the most images a group
    touched."""
    wo, ho = win + 2 * pad - 1, hin + 2 * pad - 1
    hwo, hw = ho * wo, hin * win
    st = wgrad_groups(b, cin, hin, win, pad, n_out)
    span_a = wgrad_span_a(b, hin, win, pad, st['length'])
    span_b = wgrad_span_b(b, hwo, st['length'])
    tn = tile_cols(n_out)
    assert wgrad_smem(tn, span_a, span_b, cin, win) <= SMEM_LIMIT
    assert st['nr'].max() <= wgrad_images(b, hwo, st['length'])
    # 16-byte chunks of every run of every channel (each residue of the
    # plane offset mod 8, and the last channels): aligned, in the padded
    # allocation, and inside the channel's region
    for n_chan, plane, lo, hi, cap0, span in (
            (cin, hw, st['lo_a'], st['hi_a'], st['cap_a'], span_a),
            (n_out, hwo, st['r0'], st['hi_g'], st['cap_g'], span_b)):
        alloc = _cdiv(b * n_chan * plane, 8) * 8
        channels = np.unique(np.r_[np.arange(min(8, n_chan)),
                                   np.arange(max(0, n_chan - 8), n_chan)])
        for rr in range(int(st['nr'].max())):
            s, e, dst, lo_r, hi_r = _runs(st, rr, channels, n_chan, plane,
                                          lo, hi, cap0)
            assert (s >= 0).all() and (e <= alloc).all()
            assert ((e - s) <= run_cap(hi_r - lo_r)[:, None]).all()
            assert (dst + (e - s) <= span).all()
    valid = st['valid']
    first = st['b'] == st['b0'][:, None]
    lastimg = st['b'] == st['b0'][:, None] + st['nr'][:, None] - 1
    # every in-image tap of every valid pixel lies in its run and is read
    # where the copy put it: region offset da + (qa + ci hw) % 8 + tap
    hi_pix = np.where(lastimg, st['hi_a'][:, None], hw)
    at_a = np.where(first, 0, st['cap_a'][:, None] +
                    (st['b'] - st['b0'][:, None] - 1) * run_cap(hw))
    for dy in (0, 1):
        for dx in (0, 1):
            iy, ix = st['oy'] - pad + dy, st['ox'] - pad + dx
            inside = valid & (iy >= 0) & (iy < hin) & (ix >= 0) & (ix < win)
            local = st['tb'] + dy * win + dx
            assert ((st['la'] <= local) & (local < hi_pix))[inside].all()
            for ci in sorted({0, 1, cin - 1}):
                plane0 = (st['b'] * cin + ci) * hw
                s = (plane0 + st['la']) & ~7
                pos = st['da'] + ((st['qa'] + ci * hw) & 7) + dy * win + dx
                assert (pos == at_a + plane0 + local - s)[inside].all()
                assert ((0 <= pos) & (pos < span_a))[inside].all()
    # the unmasked loads of every tap, in or out of the image: no further
    # than win + 1 elements before the region (into the operand buffers)
    # nor win + 8 past it (the room the launch leaves past the ring)
    assert 2 * (win + 1) <= 4 * NBUF * (WGRAD_TM + tn) * 16
    assert (st['da'] >= -(win + 1)).all()
    assert (st['da'] + 7 + win + 1 < span_a + win + 8).all()
    # every valid pixel's gradient value, likewise, for each residue of
    # the channel's plane offset
    hi_g = np.where(lastimg, st['hi_g'][:, None], hwo)
    assert ((st['lg'] <= st['r']) & (st['r'] < hi_g))[valid].all()
    at_g = np.where(first, 0, st['cap_g'][:, None] +
                    (st['b'] - st['b0'][:, None] - 1) * run_cap(hwo))
    for n in sorted({0, 1, 2, 3, n_out - 1}):
        plane0 = (st['b'] * n_out + n) * hwo
        s = (plane0 + st['lg']) & ~7
        pos = st['dg'] + ((st['qg'] + n * hwo) & 7)
        assert (pos == at_g + plane0 + st['r'] - s)[valid].all()
        assert ((0 <= pos) & (pos < span_b)).all()
    return int(st['nr'].max())


def _wgrad_launches(b, cin, h, w, cout):
    """The block's two bf16 wgrad launches: (x's channels, Hin, Win, pad,
    n_out): dW2 over y1 and g2, dW1 over x and dy1."""
    return {'dW2': (cout, h + 1, w + 1, 0, cout), 'dW1': (cin, h, w, 1, cout)}


WGRAD_BLOCKS = [(27, 70), (70, 70), (280, 280), (280, 108)]
WGRAD_CASES = [((64, 96, 96), blk) for blk in WGRAD_BLOCKS] + \
    [((3, 13, 17), blk) for blk in WGRAD_BLOCKS] + \
    [((3, 12, 14), blk) for blk in WGRAD_BLOCKS] + \
    [((1, 96, 96), (280, 280)), ((1, 13, 17), (70, 70)),
     ((2, 5, 3), (27, 70))]


@pytest.mark.parametrize('launch', ['dW2', 'dW1'])
@pytest.mark.parametrize('size,block', WGRAD_CASES,
                         ids=[f'B{s[0]}_{s[1]}x{s[2]}_{c[0]}to{c[1]}'
                              for s, c in WGRAD_CASES])
def test_wgrad_span_rule_covers_every_tap(size, block, launch):
    b, h, w = size
    cin, hin, win, pad, n_out = _wgrad_launches(b, block[0], h, w,
                                                block[1])[launch]
    check_wgrad_launch(b, cin, hin, win, pad, n_out)


def test_wgrad_spans_at_the_recipe():
    """The recipe's wgrad regions (B 64, 96², chunks of 4096 pixels):
    dW2's groups never leave an image (96² pixels is whole groups), dW1's
    cross one at most; a 280->280 half of the ring is ~62 KB, and every
    launch of the recipe's blocks fits the card."""
    assert wgrad_chunks(64, 280, 97, 97, 280, 0) == (4096, 144)
    assert wgrad_chunks(64, 280, 96, 96, 280, 1) == (4096, 148)
    assert wgrad_images(64, 96 * 96, 4096) == 1
    assert wgrad_images(64, 97 * 97, 4096) == 2
    assert (wgrad_span_a(64, 97, 97, 0, 4096),
            wgrad_span_b(64, 96 * 96, 4096)) == (248, 160)
    assert (wgrad_span_a(64, 96, 96, 1, 4096),
            wgrad_span_b(64, 97 * 97, 4096)) == (256, 160)
    for cin, cout in WGRAD_BLOCKS + [(280, 2)]:
        for c, hin, win, pad, n_out in _wgrad_launches(64, cin, 96, 96,
                                                       cout).values():
            length = wgrad_chunks(64, c, hin, win, n_out, pad)[0]
            sa = wgrad_span_a(64, hin, win, pad, length)
            sb = wgrad_span_b(64, (hin + 2 * pad - 1) * (win + 2 * pad - 1),
                              length)
            assert wgrad_smem(tile_cols(n_out), sa, sb, c, win) <= SMEM_LIMIT


def test_wgrad_many_images_a_group():
    """Images smaller than a group: a run per image, the middle ones whole
    planes; and groups that cross images, ragged last groups."""
    assert check_wgrad_launch(40, 8, 3, 4, 0, 8) > 2
    assert check_wgrad_launch(40, 8, 2, 3, 1, 70) > 2
    st = wgrad_groups(3, 70, 13, 17, 1, 70)
    assert (st['nr'] == 2).any() and st['valid'].sum(1).min() < PIX


@pytest.mark.parametrize('tn', [144, 112, 72, 32, 8])
def test_wgrad_transform_lanes_cover_the_tiles(tn):
    """The transform's threads (warp w, lane) and loop steps i write every
    word of the A tile (rows c * 4 + tap of the 32 channels) and of the B
    tile's tn rows exactly once, a warp instruction two rows (128 bytes)."""
    a, bt = np.zeros((WGRAD_TM, 16), int), np.zeros((tn, 16), int)
    for w in range(8):
        for lane in range(32):
            hi16, k, dy = lane >> 4, lane & 15, w & 1
            for i in range(CA * 2 // 8):
                a[((w >> 1) + 4 * i) * 4 + 2 * dy + hi16, k] += 1
            for i in range(_cdiv(tn // 2, 8)):
                n = 2 * (w + 8 * i) + hi16
                if n < tn:
                    bt[n, k] += 1
    assert (a == 1).all() and (bt == 1).all()


@pytest.mark.parametrize('b,h,w,pad', [(3, 13, 17, 1), (3, 12, 14, 0),
                                       (2, 5, 3, 1), (40, 2, 3, 0)],
                         ids=['pad1_13x17', 'pad0_12x14', 'pad1_5x3',
                              'pad0_many_images'])
def test_wgrad_transform_equals_im2col(b, h, w, pad):
    """A numpy model of the span wgrad's copies and transform: each group's
    regions filled run by run as the bulk copies fill them (16-byte chunks
    of the flat tensors), then every pixel's A values (rows (ci, tap)) and
    B values (row n) read through the pixel table with the transform's
    offsets and masks.  Both equal an explicit im2col of x (zero padding,
    pixels past the end zero) and the gradient's values."""
    cin, n_out = 11, 6
    rng = np.random.default_rng(h * w + pad)
    x = rng.integers(1, 1000, (b, cin, h, w))
    wo, ho = w + 2 * pad - 1, h + 2 * pad - 1
    hwo, hw = ho * wo, h * w
    g = rng.integers(1, 1000, (b, n_out, ho, wo))
    st = wgrad_groups(b, cin, h, w, pad, n_out)
    span_a = wgrad_span_a(b, h, w, pad, st['length'])
    span_b = wgrad_span_b(b, hwo, st['length'])
    xf, gf = x.ravel(), g.ravel()
    xf = np.r_[xf, np.zeros(_cdiv(xf.size, 8) * 8 - xf.size, int)]
    gf = np.r_[gf, np.zeros(_cdiv(gf.size, 8) * 8 - gf.size, int)]
    zpad = np.pad(x, ((0, 0), (0, 0), (pad, pad), (pad, pad)))
    for k in range(len(st['m'])):
        v, bb, oy, ox = (st[n][k] for n in ('valid', 'b', 'oy', 'ox'))
        regions = {}
        for name, flat, n_chan, plane, lo, hi, cap0, span in (
                ('a', xf, cin, hw, st['lo_a'][k], st['hi_a'][k],
                 st['cap_a'][k], span_a),
                ('g', gf, n_out, hwo, st['r0'][k], st['hi_g'][k],
                 st['cap_g'][k], span_b)):
            reg = np.full((n_chan, span), -1)
            for c in range(n_chan):
                for rr in range(st['nr'][k]):
                    p = ((st['b0'][k] + rr) * n_chan + c) * plane
                    s = (p + (lo if rr == 0 else 0)) & ~7
                    e = (p + (hi if rr == st['nr'][k] - 1 else plane) + 7) \
                        & ~7
                    d = 0 if rr == 0 else cap0 + (rr - 1) * run_cap(plane)
                    reg[c, d:d + e - s] = flat[s:e]
            regions[name] = reg
        for ci in range(cin):
            for dy in (0, 1):
                for dx in (0, 1):
                    iy, ix = oy - pad + dy, ox - pad + dx
                    inside = v & (iy >= 0) & (iy < h) & (ix >= 0) & (ix < w)
                    pos = st['da'][k] + ((st['qa'][k] + ci * hw) & 7) + \
                        dy * w + dx
                    got = np.where(inside, regions['a'][ci][
                        np.clip(pos, 0, span_a - 1)], 0)
                    want = np.where(v, zpad[bb % b, ci,
                                            (oy + dy) % zpad.shape[2],
                                            (ox + dx) % zpad.shape[3]], 0)
                    np.testing.assert_array_equal(got, want)
        for n in range(n_out):
            pos = st['dg'][k] + ((st['qg'][k] + n * hwo) & 7)
            got = np.where(v, regions['g'][n][pos], 0)
            want = np.where(v, g[bb % b, n, oy % ho, ox % wo], 0)
            np.testing.assert_array_equal(got, want)


# The handoff of operand buffers between the producers and the consumers
# of every K3 GEMM (``produce``, ``produce_spans``, ``produce_wgrad_spans``
# and ``consume``), restated.  NBUF buffers (a constant of the instance, as
# CHAIN); stage kt lives in buffer kt % NBUF.  The consumers take the
# stages in chains of J = CHAIN: for
# each stage they wait for its buffer to be full, issue its products and
# commit them, wait until at most one group of products is pending, and
# free the buffer of the stage before if it is in the same chain; at a
# chain's end they wait for all and free its last buffer.  A buffer is
# freed only if a later stage will refill it (stage + NBUF < steps).  The
# epilogue's tile then overwrites the buffers.  The span conv GEMMs'
# producers write a buffer's weight rows a stage ahead (at stage kt they
# wait until the buffer of kt + 1 is free and copy its weights), then its
# A tile at kt; the word ring's producers and the wgrads' wait for the
# buffer at kt.  Products complete in order, at any time after their
# commit, and at the latest when a wait needs them.

def _handoff(path, steps, nbuf, chain, policy, rng, early=False):
    """Runs one schedule of the handoff; asserts that no buffer is written
    while products may still read its stage, that the buffer barriers
    alternate (never two arrivals of one side ahead), that every stage is
    consumed once, and that the schedule ends with every arrival matched.
    ``early``: the consumers free stage kt itself (a fault, to show that
    the model finds it)."""
    prod = []
    if path == 'spans':
        prod.append(('write', 0))            # stage 0's weight rows
    for kt in range(steps):
        if path == 'spans':
            prod.append(('write', kt))       # the A tile
            if kt + 1 < steps:
                if kt + 1 >= nbuf:
                    prod.append(('wait_free', kt + 1))
                prod.append(('write', kt + 1))
        else:
            if kt >= nbuf:
                prod.append(('wait_free', kt))
            prod.append(('write', kt))
        prod.append(('publish', kt))
    cons = []

    def release(stage):
        if stage + nbuf < steps:
            cons.append(('release', stage))

    for k0 in range(0, steps, chain):
        n = min(chain, steps - k0)
        for kt in range(k0, k0 + n):
            cons += [('wait_full', kt), ('issue', kt), ('wait_pending', 1)]
            if early:
                release(kt)
            elif kt > k0:
                release(kt - 1)
        cons.append(('wait_pending', 0))
        if not early:
            release(k0 + n - 1)
    cons.append(('epilogue', None))

    fills, taken = [0] * nbuf, [0] * nbuf
    frees, waited = [0] * nbuf, [0] * nbuf
    pending, issued = [], []
    pc = cc = 0

    def enabled(op, arg):
        b = arg % nbuf if isinstance(arg, int) else 0
        if op == 'wait_free':
            return frees[b] >= arg // nbuf
        if op == 'wait_full':
            return fills[b] >= arg // nbuf + 1
        if op == 'wait_pending':
            return len(pending) <= arg
        return True

    def run(op, arg):
        b = arg % nbuf if isinstance(arg, int) else 0
        if op == 'write':
            old = arg - nbuf
            assert old < 0 or old in issued, ('overwrites unread', arg)
            assert old not in pending, ('refills a buffer still read', arg,
                                        steps)
        elif op == 'wait_free':
            waited[b] += 1
        elif op == 'publish':
            fills[b] += 1
            assert fills[b] - taken[b] <= 1, ('two fills ahead', arg)
        elif op == 'wait_full':
            taken[b] += 1
        elif op == 'issue':
            pending.append(arg)
            issued.append(arg)
        elif op == 'release':
            frees[b] += 1
            assert frees[b] - waited[b] <= 1, ('two frees ahead', arg)
        elif op == 'epilogue':
            assert pc == len(prod), 'the tile overwrites a stage in flight'

    while pc < len(prod) or cc < len(cons):
        moves = []
        if pc < len(prod) and enabled(*prod[pc]):
            moves.append('p')
        if cc < len(cons) and enabled(*cons[cc]):
            moves.append('c')
        if pending:
            moves.append('done')
        assert moves, ('deadlock', path, steps, prod[pc:pc + 1],
                       cons[cc:cc + 1])
        if policy == 'producers':        # completions as late as possible
            move = next(m for m in ('p', 'c', 'done') if m in moves)
        elif policy == 'consumers':
            move = next(m for m in ('c', 'done', 'p') if m in moves)
        else:
            move = moves[rng.integers(len(moves))]
        if move == 'p':
            run(*prod[pc])
            pc += 1
        elif move == 'c':
            run(*cons[cc])
            cc += 1
        else:
            pending.pop(0)
    assert issued == list(range(steps)) and not pending
    assert fills == taken and frees == waited


@pytest.mark.parametrize('instance,path', [('Bf16', 'spans'),
                                           ('Bf16', 'ring'),
                                           ('Tf32x3', 'ring')],
                         ids=['bf16_conv', 'bf16_wgrad', 'fp32'])
def test_buffer_handoff_with_stages_in_flight(instance, path):
    """Every loop length from 1 to 72 stages (the recipe's 280-channel
    conv GEMMs take 35 bf16 stages, 70 fp32 ones), under the schedule that
    completes products as late as it can, the one that runs the consumers
    first, and random ones.  The bf16 conv GEMMs take the span producers,
    the bf16 wgrads and every fp32 GEMM wait for a buffer at its stage."""
    nbuf, chain = _instance(instance, 'NBUF'), _instance(instance, 'CHAIN')
    rng = np.random.default_rng(len(path))
    for steps in range(1, 73):
        for policy in ('producers', 'consumers', 'random', 'random'):
            _handoff(path, steps, nbuf, chain, policy, rng)


def test_buffer_handoff_model_finds_an_early_release():
    """Freeing the buffer of the stage just committed while its products
    are in flight is caught: the producers refill a buffer still read."""
    rng = np.random.default_rng(0)
    with pytest.raises(AssertionError, match='refills a buffer still read'):
        for steps in range(1, 73):
            _handoff('spans', steps, NBUF, _instance('Bf16', 'CHAIN'),
                     'producers', rng, early=True)
