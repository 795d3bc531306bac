"""The fused double-conv block of ``scripts/pallas_block_probe.py`` on the
card: its canvas helpers, ``fused_block``, ``chain_pallas`` and the
``check`` / ``bench`` drives.

    python -m mmlf_tpu_torch.probes.block_probe check [--device cpu]
    python -m mmlf_tpu_torch.probes.block_probe bench

The script's Pallas kernel (``fused_block``) computes, per image of a
zero-ringed row-major canvas ``(B, C, M)`` (stride ``S = W + 2``, data at
rows 1..H and columns 1..W, ``LEAD`` zeros before and ``TRAIL`` after):

    y1 = relu(conv2×2_pad1(x) + b1)        on the (H+1)×(W+1) region
    y2 = [relu](conv2×2_pad0(y1) + b2)     placed at the interior

and leaves the ring of both canvases as garbage (its consumer masks,
``chain_pallas`` between blocks).  That is kernel K3's forward with no
input stage and no sums (``ops/kernels/conv_block.fused_block_fwd``,
``csrc/conv_block.cu`` with ``FWD_RELU_OUT`` / ``FWD_NO_STATS``): the
wrapper here cuts the canvas interior into NCHW, runs K3, and writes y1 and
y2 into fresh zero canvases.  Weights are HWIO ``(2, 2, Cin, Cout)`` as the
script takes them.  On CPU tensors K3's plain version runs; on CUDA the
kernel, in 3×TF32 for float32 and ``wgmma`` .bf16 for bfloat16.

Bound on an H100 SXM, for ``bench``'s 7-block chain at B 64, 96×96: the
script's count ``7·2·B·H·W·4·C²·2`` (conv 1 taken over H×W, not
(H+1)×(W+1)) is 5.18e12 FLOP at C 280 and 4.33e12 at C 256, ≥ 5.24 ms and
≥ 4.38 ms at 989 TFLOP/s bf16.
"""

from __future__ import annotations

import sys
import time

import numpy as np
import torch
from torch.nn import functional as F

from ..ops.kernels import conv_block
from ..utils.device import resolve_device
from . import cuda_ms

LEAD = 128          # zero margin before the canvas (negative-tap reads)
TRAIL = 128         # zero margin after (past-end tap reads); >= S+1
TILE = 512          # pixel tile of the script's GEMMs: the canvas rounds to it
PEAK_BF16 = 989e12  # H100 SXM dense bf16 tensor-core FLOP/s
BENCH = ((280, 64), (256, 64))      # (C, B) of bench, 96×96, 7 blocks
BENCH_HW, BENCH_BLOCKS = 96, 7


def canvas_dims(h: int, w: int):
    """``(S, P, Mc, M)``: stride, ringed pixels, tiled length, canvas."""
    s = w + 2
    p = (h + 2) * s
    mc = -(-p // TILE) * TILE
    return s, p, mc, LEAD + mc + TRAIL


def to_canvas(x_nhwc: torch.Tensor, m: int) -> torch.Tensor:
    """``(B, H, W, C)`` → ``(B, C, M)`` zero-ringed canvas."""
    b, h, w, c = x_nhwc.shape
    s, p, mc, m_ = canvas_dims(h, w)
    assert m_ == m
    xp = F.pad(x_nhwc, (0, 0, 1, 1, 1, 1)).reshape(b, p, c)
    return F.pad(xp.transpose(1, 2), (LEAD, m - LEAD - p))


def from_canvas(xc: torch.Tensor, h: int, w: int) -> torch.Tensor:
    """``(B, C, M)`` canvas → ``(B, H, W, C)`` interior."""
    b, c, _ = xc.shape
    s, p, _, _ = canvas_dims(h, w)
    xp = xc[:, :, LEAD:LEAD + p].reshape(b, c, h + 2, s)
    return xp[:, :, 1:h + 1, 1:w + 1].permute(0, 2, 3, 1)


def _grid(xc: torch.Tensor, h: int, w: int) -> torch.Tensor:
    """The canvas's ``(B, C, H+2, S)`` pixel grid, a view."""
    s, p, _, _ = canvas_dims(h, w)
    return xc[:, :, LEAD:LEAD + p].view(xc.shape[0], xc.shape[1], h + 2, s)


def defined(y1c, y2c, h: int, w: int):
    """The values a fused block defines, as views: y1 on its (H+1)×(W+1)
    region and y2 on the interior (the rest of both canvases is garbage by
    the script's contract)."""
    return (_grid(y1c, h, w)[:, :, :h + 1, :w + 1],
            _grid(y2c, h, w)[:, :, 1:h + 1, 1:w + 1])


def interior_mask(h: int, w: int, m: int) -> np.ndarray:
    """``(M,)`` bool: the canvas positions of the H×W interior."""
    s, p, _, _ = canvas_dims(h, w)
    idx = np.arange(m) - LEAD
    iy, ix = idx // s, idx % s
    return (idx >= 0) & (idx < p) & (iy >= 1) & (iy <= h) & (ix >= 1) & \
        (ix <= w)


def block_on_canvas(fn, xc, w1, b1, w2, b2, h: int, w: int,
                    relu_out: bool = True):
    """Run ``fn(x, w1, b1, w2, b2, relu_out) -> (y1, y2)`` on NCHW (K3's
    ``fused_block_fwd`` or its plain version) for a canvas ``xc``; returns
    the ``(y1c, y2c)`` canvases (zero rings).  HWIO weights; float64 ones
    stay float64 (a float64 evaluation), others run as float32."""
    dtype = torch.float64 if w1.dtype == torch.float64 else torch.float32
    oihw = [a.permute(3, 2, 0, 1).to(dtype) for a in (w1, w2)]
    x = _grid(xc, h, w)[:, :, 1:h + 1, 1:w + 1].contiguous()
    y1, y2 = fn(x, oihw[0], b1.to(dtype), oihw[1], b2.to(dtype), relu_out)
    b, c = y2.shape[:2]
    y1c = torch.zeros((b, c, xc.shape[2]), dtype=y1.dtype, device=xc.device)
    y2c = torch.zeros_like(y1c)
    _grid(y1c, h, w)[:, :, :h + 1, :w + 1] = y1
    _grid(y2c, h, w)[:, :, 1:h + 1, 1:w + 1] = y2
    return y1c, y2c


def fused_block(xc, w1, b1, w2, b2, h: int, w: int, relu_out: bool = True):
    """The script's ``fused_block``: ``(y1c, y2c)`` canvases in xc's dtype
    through K3 (its plain version for CPU tensors).  y2 is not masked."""
    return block_on_canvas(conv_block.fused_block_fwd, xc, w1, b1, w2, b2, h,
                           w, relu_out)


def plain_fused_block(xc, w1, b1, w2, b2, h: int, w: int,
                      relu_out: bool = True):
    """``fused_block`` through K3's plain version on any device."""
    return block_on_canvas(conv_block.plain_fused_block, xc, w1, b1, w2, b2,
                           h, w, relu_out)


def direct_block(x, w1, b1, w2, b2, relu_out: bool = True):
    """The script's ``xla_block`` on NHWC: conv pad 1, ReLU, conv pad 0
    (cuDNN on the card).  Float convs of bf16 inputs run in bf16."""
    x = x.permute(0, 3, 1, 2)
    y = torch.relu(F.conv2d(x, w1.permute(3, 2, 0, 1), b1, padding=1))
    y = F.conv2d(y, w2.permute(3, 2, 0, 1), b2)
    y = torch.relu(y) if relu_out else y
    return y.permute(0, 2, 3, 1)


def make_params(rng, n_blocks: int, c: int, dtype, device):
    """The script's ``make_params``: per block ``(w1, b1, w2, b2)``, HWIO
    weights of std ``1/sqrt(4C)`` and biases of std 0.1, in ``dtype``."""
    ws = []
    for _ in range(n_blocks):
        w1 = rng.standard_normal((2, 2, c, c)) / np.sqrt(4 * c)
        w2 = rng.standard_normal((2, 2, c, c)) / np.sqrt(4 * c)
        b1 = rng.standard_normal(c) * 0.1
        b2 = rng.standard_normal(c) * 0.1
        ws.append(tuple(torch.as_tensor(a, dtype=torch.float64)
                        .to(dtype).to(device) for a in (w1, b1, w2, b2)))
    return ws


def chain_pallas(params, xc, h: int, w: int, block=fused_block):
    """The script's ``chain_pallas``: each block's y2, masked to the
    interior, feeds the next."""
    mask = torch.as_tensor(interior_mask(h, w, xc.shape[2])[None],
                           dtype=xc.dtype, device=xc.device)
    for w1, b1, w2, b2 in params:
        _, y2 = block(xc, w1, b1, w2, b2, h, w)
        xc = y2 * mask
    return xc


def chain_direct(params, x):
    """The script's ``chain_xla`` (on the card: cuDNN's convs)."""
    for w1, b1, w2, b2 in params:
        x = direct_block(x, w1, b1, w2, b2)
    return x


def check(device='cuda') -> float:
    """The script's ``check``: fp32, B 2, 13×17, C 24, 2 blocks, the canvas
    chain against the direct chain; returns the max difference."""
    dev = resolve_device(device)
    rng = np.random.default_rng(0)
    h, w, c, b = 13, 17, 24, 2
    params = make_params(rng, 2, c, torch.float32, dev)
    x = torch.as_tensor(rng.standard_normal((b, h, w, c)) * 0.5,
                        dtype=torch.float32, device=dev)
    m = canvas_dims(h, w)[3]
    got = from_canvas(chain_pallas(params, to_canvas(x, m), h, w), h, w)
    d = float((got - chain_direct(params, x)).abs().max())
    print(f'max |fused - direct| = {d:.2e}')
    assert d < 1e-4
    print('CHECK OK')
    return d


def chain_flop(b: int, h: int, w: int, c: int, n_blocks: int) -> int:
    """The script's operation count of a chain (conv 1 over H×W)."""
    return n_blocks * 2 * b * h * w * 4 * c * c * 2


def bench(device='cuda', reps: int = 5, seed: int = 0) -> list:
    """The script's ``bench`` on the card: for C 280 and 256 (B 64, 96×96,
    7 blocks, bf16) the direct chain (cuDNN), the canvas-resident chain
    through K3, the same including the canvas transposes, and the chain
    through K3's plain version; each with its TFLOP/s.  Returns one dict a
    C: ``c, b, flop, bound_ms`` and the four times."""
    dev = resolve_device(device)
    if dev.type != 'cuda':
        raise RuntimeError('bench times the card: it needs device cuda')
    print(f'device: {torch.cuda.get_device_name(dev)}', flush=True)
    rng = np.random.default_rng(seed)
    h = w = BENCH_HW
    out = []
    for c, b in BENCH:
        params = make_params(rng, BENCH_BLOCKS, c, torch.bfloat16, dev)
        x = torch.as_tensor(rng.standard_normal((b, h, w, c)) * 0.3,
                            dtype=torch.bfloat16, device=dev)
        m = canvas_dims(h, w)[3]
        fl = chain_flop(b, h, w, c, BENCH_BLOCKS)
        bound_ms = fl / PEAK_BF16 * 1e3
        print(f'--- C={c} bs={b} {BENCH_BLOCKS} blocks '
              f'({2 * BENCH_BLOCKS} convs) bf16, canvas M={m}, bound '
              f'{bound_ms:.3f} ms ---', flush=True)
        xc = to_canvas(x, m)
        res = {'c': c, 'b': b, 'flop': fl, 'bound_ms': bound_ms}
        for key, name, fn in (
                ('library_ms', 'direct conv chain (cuDNN)',
                 lambda: chain_direct(params, x)),
                ('ms', 'K3 fused blocks (canvas resident)',
                 lambda: chain_pallas(params, xc, h, w)),
                ('e2e_ms', 'K3 incl. canvas transposes',
                 lambda: from_canvas(chain_pallas(params, to_canvas(x, m),
                                                  h, w), h, w)),
                ('plain_ms', 'K3 plain version (canvas resident)',
                 lambda: chain_pallas(params, xc, h, w,
                                      block=plain_fused_block))):
            res[key] = cuda_ms(fn, reps)
            print(f'{name:46s} {res[key]:8.2f} ms  '
                  f'{fl / res[key] * 1e-9:7.1f} TF/s', flush=True)
        out.append(res)
    return out


def main(argv) -> int:
    mode = argv[0] if argv else 'check'
    device = argv[argv.index('--device') + 1] if '--device' in argv \
        else 'cuda'
    if mode == 'bench':
        t = time.time()
        bench(device)
        print(f'bench done in {time.time() - t:.1f} s')
    elif mode == 'check':
        check(device)
    else:
        print(f'usage: python -m mmlf_tpu_torch.probes.block_probe '
              f'check|bench [--device cpu]', file=sys.stderr)
        return 2
    return 0


if __name__ == '__main__':
    sys.exit(main(sys.argv[1:]))
