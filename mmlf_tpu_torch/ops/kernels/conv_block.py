"""Fused double-conv trunk block (kernel K3), forward and backward.

Replaces the Pallas TPU kernel ``mmlf_tpu/ops/pallas/conv_block.py``
(``fused_double_conv``: forward ``_fwd`` / ``_fwd_kernel``, backward
``_fused_bwd_rule`` / ``_bwd_kernel``).  One block of the conv trunk on
NCHW float32 activations:

    z   = [relu]([si·x + ti])           the previous block's BN + ReLU
    y1  = relu(conv2×2_pad1(z) + b1)    (B, Cout, H+1, W+1), never saved
    y2  = conv2×2_pad0(y1) + b2         (B, Cout, H, W)
    ps, pss = Σ y2, Σ y2²               per channel over (B, H, W)

The backward recomputes y1 from ``x``; the residuals are ``x`` and ``y2``.
Weights are OIHW, as the port's ``nn.Conv2d`` holds them; the layout is the
port's NCHW (the TPU kernel's lane canvas does not carry over).

bfloat16 activations (``--bf16``) take the TPU kernel's bf16 instance: x,
y2 and dx are bf16, the weights are rounded to bf16, si, ti, the biases,
the sums and the weight gradients stay float32, and the rounding points are
the TPU kernel's (``_input_stage`` and the plain versions below spell them
out: the input affine in bf16 arithmetic, y1 and y2 rounded after their
fp32 sums, ps and pss from the fp32 y2, g2 and dy1 summed in fp32 and
rounded for their products, the input stage's relu' on the fp32
``x·si + ti``).

On CUDA tensors ``fused_double_conv_fwd`` / ``fused_double_conv_bwd``
launch the hand-written kernels of ``csrc/conv_block.cu``: every GEMM on
Hopper's tensor cores, for float32 in 3×TF32 (each fp32 operand split into
two TF32 parts, three products), which keeps fp32's accuracy, for bfloat16
in one bf16 product with fp32 sums; its note gives the bounds on an H100
(operations).  On CPU tensors they take the plain PyTorch versions beside
them.  There is no fallback: a build or launch error raises.  Each counts
its kernel launches, float32 in ``.launches`` and bfloat16 in
``.launches_bf16``.  ``fused_double_conv`` is the autograd Function the
trunk calls.

``fused_block_fwd`` is the forward with no input stage and no sums, an
optional ReLU on y2 and y1 returned: the fused block of
``scripts/pallas_block_probe.py`` (``probes/block_probe.py`` runs it on
the probe's canvas).
"""

from __future__ import annotations

import ctypes
import math

import torch
from torch.nn import functional as F

from . import build


def _bf(t):
    """``t`` rounded to bfloat16, back in its own dtype (the bf16
    instance's operands: a float32 conv of such values gives a bf16 tensor
    core's exact products, summed in another order)."""
    return t.to(torch.bfloat16).to(t.dtype)


def _input_stage(x, si, ti, relu_in: bool, affine_in: bool):
    """``(pre, z)``: the affine'd input and the input stage's output, in
    si's dtype.  For a bf16 ``x`` the stage runs in bf16 arithmetic as the
    TPU kernel's does (``x·bf16(si)`` rounded, ``+ bf16(ti)`` rounded);
    ``pre`` is then the unrounded ``x·si + ti`` its backward's relu'
    reads."""
    bf16 = x.dtype == torch.bfloat16
    x = x.to(si.dtype)
    pre = x * si[:, None, None] + ti[:, None, None] if affine_in else x
    z = pre
    if bf16 and affine_in:
        z = _bf(_bf(x * _bf(si)[:, None, None]) + _bf(ti)[:, None, None])
    return pre, (torch.relu(z) if relu_in else z)


def plain_double_conv_fwd(x, si, ti, w1, b1, w2, b2, relu_in: bool,
                          affine_in: bool):
    """Plain PyTorch version of the forward: ``(y2, ps, pss)``; y2 in x's
    dtype, the sums in si's (from the unrounded y2).  With a bf16 ``x``
    and float64 parameters it is a float64 evaluation of the bf16
    instance: the same rounding points, every sum in float64."""
    bf16 = x.dtype == torch.bfloat16
    rnd = _bf if bf16 else (lambda t: t)
    _, z = _input_stage(x, si, ti, relu_in, affine_in)
    y1 = rnd(torch.relu(F.conv2d(z, rnd(w1), b1, padding=1)))
    y2 = F.conv2d(y1, rnd(w2), b2)
    return y2.to(x.dtype), y2.sum((0, 2, 3)), (y2 * y2).sum((0, 2, 3))


def plain_double_conv_bwd(x, si, ti, w1, b1, w2, y2, dy2, dps, dpss,
                          relu_in: bool, affine_in: bool):
    """Plain PyTorch version of the backward, the formulas of the TPU
    kernel's ``_bwd_kernel`` written out (no autograd): ``(dx, dsi, dti,
    dw1, db1, dw2, db2)``; dx in x's dtype, the rest in si's."""
    grad = torch.nn.grad
    bf16 = x.dtype == torch.bfloat16
    rnd = _bf if bf16 else (lambda t: t)
    pre, z = _input_stage(x, si, ti, relu_in, affine_in)
    w1, w2 = rnd(w1), rnd(w2)
    y1 = rnd(torch.relu(F.conv2d(z, w1, b1, padding=1)))
    g2 = dy2.to(dps.dtype) + dps[:, None, None] + \
        2.0 * y2.to(dps.dtype) * dpss[:, None, None]
    dy1 = grad.conv2d_input(y1.shape, w2, rnd(g2)) * (y1 > 0)
    dw2 = grad.conv2d_weight(y1, w2.shape, rnd(g2))
    dz = grad.conv2d_input(z.shape, w1, rnd(dy1), padding=1)
    dw1 = grad.conv2d_weight(z, w1.shape, rnd(dy1), padding=1)
    if relu_in:
        dz = dz * (pre > 0)
    if affine_in:
        dsi, dti = (dz * x.to(dz.dtype)).sum((0, 2, 3)), dz.sum((0, 2, 3))
        dx = dz * si[:, None, None]
    else:
        dsi, dti = torch.zeros_like(si), torch.zeros_like(ti)
        dx = dz
    return (dx.to(x.dtype), dsi, dti, dw1, dy1.sum((0, 2, 3)), dw2,
            g2.sum((0, 2, 3)))


def _check(x, si, ti, w1, b1, w2, tensors) -> None:
    """Shapes, dtypes and devices of one block's arguments (si and ti may
    be None: no input stage)."""
    if x.ndim != 4:
        raise ValueError(f'x must be (B, Cin, H, W), got {tuple(x.shape)}')
    cin, cout = x.shape[1], w1.shape[0]
    want = {'si': (cin,), 'ti': (cin,), 'w1': (cout, cin, 2, 2),
            'b1': (cout,), 'w2': (cout, cout, 2, 2)}
    for name, t in (('si', si), ('ti', ti), ('w1', w1), ('b1', b1),
                    ('w2', w2)):
        if t is not None and tuple(t.shape) != want[name]:
            raise ValueError(f'{name} has shape {tuple(t.shape)}, expected '
                             f'{want[name]}')
    if x.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f'x must be float32 or bfloat16, got {x.dtype}')
    for name, t in tensors:
        # the activations take x's dtype, the parameters and sums float32
        want_dtype = x.dtype if name in ('x', 'y2', 'dy2') else torch.float32
        if t.dtype != want_dtype:
            raise TypeError(f'{name} must be {want_dtype}, got {t.dtype}')
        if t.device != x.device:
            raise ValueError(f'{name} is on {t.device}, x on {x.device}')
    if x.device.type not in ('cpu', 'cuda'):
        raise ValueError(f'no fused double conv for device {x.device}')


def _gemm_weight(w):
    """OIHW conv weight → the kernel's K-major ``(Cout, 4·Cin)`` GEMM weight
    (k = ci·4 + tap, the OIHW order)."""
    return w.reshape(w.shape[0], -1).contiguous()


def _dgrad_weight(w):
    """GEMM weight of the dgrad conv of ``w``: the kernel flipped in space
    and in/out swapped (pad 1 ↔ pad 0)."""
    return _gemm_weight(w.transpose(0, 1).flip(2, 3))


def _gemm_weight_bf16(w):
    """The bf16 instance's GEMM weight: ``_gemm_weight`` rounded to bf16,
    K zero-padded to whole stages of 32 (Cin up to a multiple of 8), and
    stage-major ``(steps, Cout, 32)``, so that a stage's rows of a block's
    output channels are one contiguous copy.  Each row's four 16-byte
    chunks sit where the kernel's swizzled operand tile wants them: chunk
    c of row n at c ^ ((n >> 1) & 3)."""
    cout, cin = w.shape[:2]
    steps = -(-cin // 8)
    out = torch.zeros((cout, 32 * steps), dtype=torch.bfloat16,
                      device=w.device)
    out[:, :4 * cin] = w.reshape(cout, -1)
    out = out.view(cout, steps, 4, 8).transpose(0, 1)
    n = torch.arange(cout, device=w.device)[:, None]
    place = torch.arange(4, device=w.device)[None] ^ ((n >> 1) & 3)
    return out[:, n, place].reshape(steps, cout, 32)


def _ptrs(*tensors):
    return [t.data_ptr() for t in tensors]


def _launch(name: str, args, n_ptrs: int) -> None:
    """Launch ``name`` with ``n_ptrs`` pointers, then ints, the last two
    arguments the device index and the stream."""
    lib = build.load('conv_block')
    fn = getattr(lib, name)
    fn.restype = ctypes.c_int
    fn.argtypes = [ctypes.c_void_p] * n_ptrs + \
        [ctypes.c_int] * (len(args) - n_ptrs - 1) + [ctypes.c_void_p]
    build.check(lib, fn(*args), f'{name} launch')


def wgrad_scratch(b: int, cin: int, h: int, w: int, cout: int,
                  bf16: bool = False) -> int:
    """Floats of weight-gradient scratch the backward kernel needs."""
    lib = build.load('conv_block')
    fn = getattr(lib, 'mmlf_conv_block_wgrad_scratch' +
                 ('_bf16' if bf16 else ''))
    fn.restype = ctypes.c_longlong
    fn.argtypes = [ctypes.c_int] * 5
    return int(fn(b, cin, h, w, cout))


def fused_double_conv_fwd(x, si, ti, w1, b1, w2, b2, relu_in: bool,
                          affine_in: bool):
    """Forward of one trunk block: ``(y2, ps, pss)``.

    :param x: ``(B, Cin, H, W)`` float32 or bfloat16 block input (y2
        comes back in its dtype)
    :param si, ti: ``(Cin,)`` input affine (read only with ``affine_in``)
    :param w1, b1: ``(Cout, Cin, 2, 2)``, ``(Cout,)``; conv 1, pad 1
    :param w2, b2: ``(Cout, Cout, 2, 2)``, ``(Cout,)``; conv 2, pad 0
    """
    _check(x, si, ti, w1, b1, w2, (('x', x), ('si', si), ('ti', ti),
                                   ('w1', w1), ('b1', b1), ('w2', w2),
                                   ('b2', b2)))
    if b2.shape != b1.shape:
        raise ValueError(f'b2 has shape {tuple(b2.shape)}, expected '
                         f'{tuple(b1.shape)}')
    if x.device.type == 'cpu':
        return plain_double_conv_fwd(x, si, ti, w1, b1, w2, b2, relu_in,
                                     affine_in)
    b, cin, h, w = x.shape
    cout = w1.shape[0]
    x, si, ti, b1, b2 = (t.contiguous() for t in (x, si, ti, b1, b2))
    new = dict(dtype=torch.float32, device=x.device)
    if x.dtype == torch.bfloat16:
        return _fwd_bf16(x, si, ti, w1, b1, w2, b2, relu_in, affine_in, new)
    y1 = torch.empty((b, cout, h + 1, w + 1), **new)
    y2 = torch.empty((b, cout, h, w), **new)
    part = torch.empty(2 * b * cout, **new)
    ps, pss = torch.empty(cout, **new), torch.empty(cout, **new)
    # the weights' GEMM copies stay referenced until the launch is queued
    w1g, w2g = _gemm_weight(w1), _gemm_weight(w2)
    args = _ptrs(x, si, ti, w1g, b1, w2g, b2, y1, y2, part, ps, pss)
    _launch('mmlf_conv_block_fwd',
            args + [b, cin, h, w, cout, int(relu_in), int(affine_in), 0,
                    x.device.index,
                    torch.cuda.current_stream(x.device).cuda_stream], 12)
    fused_double_conv_fwd.launches += 1
    return y2, ps, pss


fused_double_conv_fwd.launches = 0
fused_double_conv_fwd.launches_bf16 = 0


def _canvas(shape, device):
    """An empty bf16 canvas at a 16-byte aligned address whose allocation
    runs on to the next 16-byte boundary past its last element."""
    n = math.prod(shape)
    flat = torch.empty(-(-n // 8) * 8, dtype=torch.bfloat16, device=device)
    return flat[:n].view(shape)


def _aligned(x):
    """``x`` (contiguous bf16) as the bf16 conv kernels read it: at a
    16-byte aligned address, in an allocation that runs on to the next
    16-byte boundary past its last element.  Their producers copy whole
    16-byte chunks of x with bulk copies, which take 16-byte aligned
    addresses and sizes only; a copy is made when x is not so placed."""
    room = x.untyped_storage().nbytes() - x.storage_offset() * 2
    if x.data_ptr() % 16 == 0 and room >= -(-x.numel() // 8) * 16:
        return x
    out = _canvas(x.shape, x.device)
    out.copy_(x)
    return out


def _fwd_bf16(x, si, ti, w1, b1, w2, b2, relu_in, affine_in, new):
    """The bf16 instance's forward launch (arguments checked)."""
    x = _aligned(x)
    b, cin, h, w = x.shape
    cout = w1.shape[0]
    bf = dict(dtype=torch.bfloat16, device=x.device)
    y1 = _canvas((b, cout, h + 1, w + 1), x.device)
    y2 = torch.empty((b, cout, h, w), **bf)
    y2f = torch.empty((b, cout, h, w), **new)
    part = torch.empty(2 * b * cout, **new)
    ps, pss = torch.empty(cout, **new), torch.empty(cout, **new)
    w1g, w2g = _gemm_weight_bf16(w1), _gemm_weight_bf16(w2)
    args = _ptrs(x, si, ti, w1g, b1, w2g, b2, y1, y2, y2f, part, ps, pss)
    _launch('mmlf_conv_block_fwd_bf16',
            args + [b, cin, h, w, cout, int(relu_in), int(affine_in), 0,
                    x.device.index,
                    torch.cuda.current_stream(x.device).cuda_stream], 13)
    fused_double_conv_fwd.launches_bf16 += 1
    return y2, ps, pss


# the forward's options (csrc/conv_block.cu)
FWD_RELU_OUT, FWD_NO_STATS = 1, 2


def plain_fused_block(x, w1, b1, w2, b2, relu_out: bool):
    """Plain PyTorch version of ``fused_block_fwd``: ``(y1, y2)`` in x's
    dtype.  A bf16 ``x`` takes the bf16 instance's rounding points (the
    weights rounded, y1 and y2 rounded after their fp32 sums); with
    float64 parameters it is a float64 evaluation of that arithmetic."""
    rnd = _bf if x.dtype == torch.bfloat16 else (lambda t: t)
    y1 = rnd(torch.relu(F.conv2d(x.to(b1.dtype), rnd(w1), b1, padding=1)))
    y2 = F.conv2d(y1, rnd(w2), b2)
    if relu_out:
        y2 = torch.relu(y2)
    return y1.to(x.dtype), y2.to(x.dtype)


def fused_block_fwd(x, w1, b1, w2, b2, relu_out: bool):
    """K3's forward with no input stage and no sums, y1 kept: the fused
    block of ``scripts/pallas_block_probe.py`` (``fused_block``) on NCHW
    tensors.  ``(y1, y2)``: ``y1 = relu(conv2×2_pad1(x) + b1)``
    ``(B, Cout, H+1, W+1)`` and ``y2 = [relu](conv2×2_pad0(y1) + b2)``
    ``(B, Cout, H, W)``, both in x's dtype.  Counts launches in
    ``.launches`` (float32) and ``.launches_bf16``."""
    _check(x, None, None, w1, b1, w2, (('x', x), ('w1', w1), ('b1', b1),
                                       ('w2', w2), ('b2', b2)))
    if b2.shape != b1.shape:
        raise ValueError(f'b2 has shape {tuple(b2.shape)}, expected '
                         f'{tuple(b1.shape)}')
    if x.device.type == 'cpu':
        return plain_fused_block(x, w1, b1, w2, b2, relu_out)
    b, cin, h, w = x.shape
    cout = w1.shape[0]
    x, b1, b2 = (t.contiguous() for t in (x, b1, b2))
    opts = FWD_NO_STATS | (FWD_RELU_OUT if relu_out else 0)
    stream = torch.cuda.current_stream(x.device).cuda_stream
    if x.dtype == torch.bfloat16:
        x = _aligned(x)
        y1 = _canvas((b, cout, h + 1, w + 1), x.device)
        y2 = torch.empty((b, cout, h, w), dtype=x.dtype, device=x.device)
        w1g, w2g = _gemm_weight_bf16(w1), _gemm_weight_bf16(w2)
        args = _ptrs(x) + [None, None] + _ptrs(w1g, b1, w2g, b2, y1, y2) + \
            [None] * 4
        _launch('mmlf_conv_block_fwd_bf16',
                args + [b, cin, h, w, cout, 0, 0, opts, x.device.index,
                        stream], 13)
        fused_block_fwd.launches_bf16 += 1
        return y1, y2
    y1 = torch.empty((b, cout, h + 1, w + 1), dtype=x.dtype, device=x.device)
    y2 = torch.empty((b, cout, h, w), dtype=x.dtype, device=x.device)
    w1g, w2g = _gemm_weight(w1), _gemm_weight(w2)
    args = _ptrs(x) + [None, None] + _ptrs(w1g, b1, w2g, b2, y1, y2) + \
        [None] * 3
    _launch('mmlf_conv_block_fwd',
            args + [b, cin, h, w, cout, 0, 0, opts, x.device.index, stream],
            12)
    fused_block_fwd.launches += 1
    return y1, y2


fused_block_fwd.launches = 0
fused_block_fwd.launches_bf16 = 0


def fused_double_conv_bwd(x, si, ti, w1, b1, w2, y2, dy2, dps, dpss,
                          relu_in: bool, affine_in: bool):
    """Backward of one trunk block from the residuals ``x`` and ``y2`` and
    the cotangents of ``(y2, ps, pss)``: ``(dx, dsi, dti, dw1, db1, dw2,
    db2)``.  ``dsi`` and ``dti`` are zeros without ``affine_in``."""
    _check(x, si, ti, w1, b1, w2, (('x', x), ('si', si), ('ti', ti),
                                   ('w1', w1), ('b1', b1), ('w2', w2),
                                   ('y2', y2), ('dy2', dy2), ('dps', dps),
                                   ('dpss', dpss)))
    b, cin, h, w = x.shape
    cout = w1.shape[0]
    for name, t, want in (('y2', y2, (b, cout, h, w)),
                          ('dy2', dy2, (b, cout, h, w)),
                          ('dps', dps, (cout,)), ('dpss', dpss, (cout,))):
        if tuple(t.shape) != want:
            raise ValueError(f'{name} has shape {tuple(t.shape)}, expected '
                             f'{want}')
    if x.device.type == 'cpu':
        return plain_double_conv_bwd(x, si, ti, w1, b1, w2, y2, dy2, dps,
                                     dpss, relu_in, affine_in)
    x, si, ti, b1, y2, dy2, dps, dpss = (
        t.contiguous() for t in (x, si, ti, b1, y2, dy2, dps, dpss))
    new = dict(dtype=torch.float32, device=x.device)
    if x.dtype == torch.bfloat16:
        return _bwd_bf16(x, si, ti, w1, b1, w2, y2, dy2, dps, dpss, relu_in,
                         affine_in, new)
    y1 = torch.empty((b, cout, h + 1, w + 1), **new)
    dy1 = torch.empty((b, cout, h + 1, w + 1), **new)
    g2 = torch.empty((b, cout, h, w), **new)
    wpart = torch.empty(wgrad_scratch(b, cin, h, w, cout), **new)
    bpart = torch.empty(2 * b * max(cin, cout), **new)
    dx = torch.empty_like(x)
    dw1 = torch.empty((cout, cin, 2, 2), **new)
    dw2 = torch.empty((cout, cout, 2, 2), **new)
    db1, db2 = torch.empty(cout, **new), torch.empty(cout, **new)
    dsi, dti = torch.empty(cin, **new), torch.empty(cin, **new)
    w1g, w1dg, w2dg = _gemm_weight(w1), _dgrad_weight(w1), _dgrad_weight(w2)
    args = _ptrs(x, si, ti, w1g, b1, w1dg, w2dg, y2, dy2, dps, dpss, y1, g2,
                 dy1, wpart, bpart, dx, dw1, db1, dw2, db2, dsi, dti)
    _launch('mmlf_conv_block_bwd',
            args + [b, cin, h, w, cout, int(relu_in), int(affine_in),
                    x.device.index,
                    torch.cuda.current_stream(x.device).cuda_stream], 23)
    fused_double_conv_bwd.launches += 1
    return dx, dsi, dti, dw1, db1, dw2, db2


fused_double_conv_bwd.launches = 0
fused_double_conv_bwd.launches_bf16 = 0


def _bwd_bf16(x, si, ti, w1, b1, w2, y2, dy2, dps, dpss, relu_in, affine_in,
              new):
    """The bf16 instance's backward launch (arguments checked)."""
    x = _aligned(x)
    b, cin, h, w = x.shape
    cout = w1.shape[0]
    y1 = _canvas((b, cout, h + 1, w + 1), x.device)
    g2 = _canvas((b, cout, h, w), x.device)
    dy1 = torch.empty((b, cout, h + 1, w + 1), **new)
    dy1h = _canvas((b, cout, h + 1, w + 1), x.device)
    dz = torch.empty((b, cin, h, w), **new)
    wpart = torch.empty(wgrad_scratch(b, cin, h, w, cout, bf16=True), **new)
    bpart = torch.empty(2 * b * max(cin, cout), **new)
    dx = torch.empty_like(x)
    dw1 = torch.empty((cout, cin, 2, 2), **new)
    dw2 = torch.empty((cout, cout, 2, 2), **new)
    db1, db2 = torch.empty(cout, **new), torch.empty(cout, **new)
    dsi, dti = torch.empty(cin, **new), torch.empty(cin, **new)
    w1g = _gemm_weight_bf16(w1)
    w1dg = _gemm_weight_bf16(w1.transpose(0, 1).flip(2, 3))
    w2dg = _gemm_weight_bf16(w2.transpose(0, 1).flip(2, 3))
    args = _ptrs(x, si, ti, w1g, b1, w1dg, w2dg, y2, dy2, dps, dpss, y1, g2,
                 dy1, dy1h, dz, wpart, bpart, dx, dw1, db1, dw2, db2, dsi,
                 dti)
    _launch('mmlf_conv_block_bwd_bf16',
            args + [b, cin, h, w, cout, int(relu_in), int(affine_in),
                    x.device.index,
                    torch.cuda.current_stream(x.device).cuda_stream], 25)
    fused_double_conv_bwd.launches_bf16 += 1
    return dx, dsi, dti, dw1, db1, dw2, db2


class _FusedDoubleConv(torch.autograd.Function):
    """Autograd of one trunk block.  Saves the activations ``x`` and ``y2``
    (and the small parameters), as the TPU kernel's custom VJP does; the
    backward recomputes y1."""

    @staticmethod
    def forward(ctx, x, si, ti, w1, b1, w2, b2, relu_in, affine_in):
        y2, ps, pss = fused_double_conv_fwd(x, si, ti, w1, b1, w2, b2,
                                            relu_in, affine_in)
        ctx.save_for_backward(x, si, ti, w1, b1, w2, y2)
        ctx.flags = (relu_in, affine_in)
        return y2, ps, pss

    @staticmethod
    def backward(ctx, dy2, dps, dpss):
        x, si, ti, w1, b1, w2, y2 = ctx.saved_tensors
        grads = fused_double_conv_bwd(x, si, ti, w1, b1, w2, y2, dy2, dps,
                                      dpss, *ctx.flags)
        return grads + (None, None)


def fused_double_conv(x, si, ti, w1, b1, w2, b2, relu_in: bool,
                      affine_in: bool):
    """One trunk block with autograd: ``(y2, ps, pss)`` (see
    ``fused_double_conv_fwd``); gradients flow to every tensor argument."""
    return _FusedDoubleConv.apply(x, si, ti, w1, b1, w2, b2, bool(relu_in),
                                  bool(affine_in))
