"""Batched training augmentation on the packed windows of kernel K1.

The counterpart of ``mmlf_tpu.data.augment2`` (``augment_packed`` with
``fold=True`` and ``augment_targets``): the same outputs as the per-sample
chain ``data/pipeline.augment_sample`` (sub-pixel EPI-Shift → crop →
RandomRotate → RedistColor → Brightness → Contrast), computed for the
whole batch at once.  The JAX package builds banded shift matrices and
one-hot relabel matrices for the TPU's matrix unit; here each step is an
index gather:

  * the per-(stack, view) sub-pixel roll-lerp and the crop are two gathers
    along the window rows, then two along the columns, lerped with the
    view's fraction (the circular roll of ``ops/shift.py``, restricted to
    the crop);
  * RandomRotate is one spatial gather with a per-sample (y, x) map and
    one gather over the 4·n (stack, view) slots with the relabel table;
  * the 3×3 colour mix is an einsum, brightness and contrast (pivoting on
    the h-stack mean) are elementwise;
  * the output is the model's folded NCHW layout ``(B, n*3, ps, ps)``,
    channel order view*3 + colour.

The mask is deliberately not rotated (reference quirk).

A bfloat16 window (``--cache_bf16``) is shifted where the JAX package's
matmuls round: each pass's lerp weights ``1-α`` and ``α`` are bf16 and its
result is rounded to bf16 (two exact products summed in fp32, as the bf16
matmul with two non-zeros a row); the rotation is exact, and the colour
mix, brightness and contrast run in float32.
"""

from __future__ import annotations

import numpy as np
import torch

from ..ops.shift import modf_shift_components

# per-stack shift signs along H (rows) and W (cols): h, v, i, d
# (EPI-Shift: h rolls W; v rolls H; i rolls W and -H; d rolls W and H)
ROW_SIGN = (0.0, 1.0, -1.0, 1.0)
COL_SIGN = (1.0, 0.0, 1.0, 1.0)

N_STACKS = 4
EXTRA_HALF = 8      # the crop starts at off + EXTRA//2 (data/pipeline.py)


def _relabel_table(n_views: int) -> np.ndarray:
    """``q_in[k, q_out]``: the input (stack, view) slot that lands in each
    output slot after k 90° rotations (``pipeline._rot90_sample``:
    h, v, i, d ← v, flipv(h), d, flipv(i), iterated)."""
    cur = [(s, False) for s in range(N_STACKS)]
    maps = [list(cur)]
    for _ in range(3):
        h, v, i, d = cur
        cur = [v, (h[0], not h[1]), d, (i[0], not i[1])]
        maps.append(list(cur))
    qin = np.zeros((4, N_STACKS * n_views), np.int64)
    for k in range(4):
        for s_out in range(N_STACKS):
            src, fv = maps[k][s_out]
            for v_ in range(n_views):
                v_in = n_views - 1 - v_ if fv else v_
                qin[k, s_out * n_views + v_] = src * n_views + v_in
    return qin


def aug_tensors(aug, device) -> dict:
    """``pipeline.AugParams`` (host numpy) → device tensors; crop starts
    include the EXTRA//2 band."""
    def t(a, dtype):
        return torch.as_tensor(np.asarray(a), dtype=dtype, device=device)

    return {'shift': t(aug.shift, torch.float32),
            'y0': t(aug.y_off, torch.int64) + EXTRA_HALF,
            'x0': t(aug.x_off, torch.int64) + EXTRA_HALF,
            'rot_k': t(aug.rot_k, torch.int64),
            'color': t(aug.color, torch.float32),
            'brightness': t(aug.brightness, torch.float32),
            'contrast': t(aug.contrast, torch.float32)}


def _rot_index(rot_k: torch.Tensor, ps: int):
    """Source (row, col) in the unrotated patch of every output pixel after
    ``rot_k`` rotations: ``(B, ps, ps)`` each.  One rotation maps
    ``out[y, x] = in[x, ps-1-y]``."""
    ar = torch.arange(ps, device=rot_k.device)
    y, x = ar[:, None].expand(ps, ps), ar[None, :].expand(ps, ps)
    yr, xr = ps - 1 - y, ps - 1 - x
    k = rot_k[:, None, None]
    ry = torch.where(k == 0, y, torch.where(k == 1, x,
                                            torch.where(k == 2, yr, xr)))
    rx = torch.where(k == 0, x, torch.where(k == 1, yr,
                                            torch.where(k == 2, xr, y)))
    return ry, rx


def _crop_rotate(a: torch.Tensor, y0, x0, ry, rx) -> torch.Tensor:
    """Per-sample crop of ``(B, win, win, C)`` maps at ``(y0, x0)`` through
    the pixel map ``(ry, rx)`` ``(B|1, ps, ps)`` → ``(B, ps, ps, C)``."""
    b, win, _, c = a.shape
    ps = ry.shape[-1]
    flat = ((y0[:, None, None] + ry) * win + x0[:, None, None] + rx)
    flat = flat.reshape(b, ps * ps, 1).expand(b, ps * ps, c)
    return torch.gather(a.reshape(b, win * win, c), 1, flat).reshape(
        b, ps, ps, c)


def _shift_crop(x: torch.Tensor, amt: torch.Tensor, start: torch.Tensor,
                ps: int, dim: int) -> torch.Tensor:
    """Roll-lerp + crop along ``dim`` (1 rows, 2 cols) of ``(B, Y, X, Q, 3)``
    windows: ``out[y] = (1-α)·x[(start+y-s0) mod L] + α·x[(start+y-s1)
    mod L]`` with the per-(sample, slot) shift ``amt`` ``(B, Q)``."""
    alpha, s0, s1 = modf_shift_components(amt)
    length = x.shape[dim]
    out_shape = list(x.shape)
    out_shape[dim] = ps
    y = torch.arange(ps, device=x.device)

    def take(s):
        idx = torch.remainder(start[:, None, None] + y[None, :, None]
                              - s[:, None, :], length)          # (B, ps, Q)
        idx = idx[:, :, None, :, None] if dim == 1 else \
            idx[:, None, :, :, None]
        return torch.gather(x, dim, idx.expand(out_shape))

    a = alpha[:, None, None, :, None]
    if x.dtype == torch.bfloat16:
        w0, w1 = ((1.0 - a).to(x.dtype).float(), a.to(x.dtype).float())
        return (w0 * take(s0).float() + w1 * take(s1).float()).to(x.dtype)
    return (1.0 - a) * take(s0) + a * take(s1)


def augment_packed(img: torch.Tensor, aug: dict, ps: int, views: int):
    """Augment packed image windows ``(B, win, win, CI)`` into the four
    model-layout stacks ``(B, views*3, ps, ps)`` (h, v, i, d)."""
    b, win = img.shape[0], img.shape[1]
    q = N_STACKS * views
    dev = img.device
    x = img[..., :q * 3].reshape(b, win, win, q, 3)

    # per-(sample, stack, view) shift amounts of the ORIGINAL stacks: the
    # shift precedes the rotation, as in the reference chain
    offs = torch.arange(views, dtype=torch.float32, device=dev) - \
        float(views // 2)
    s_amt = aug['shift'][:, None, None] * offs[None, None, :]  # (B, 1, n)
    row_sign = torch.tensor(ROW_SIGN, device=dev)[None, :, None]
    col_sign = torch.tensor(COL_SIGN, device=dev)[None, :, None]
    row_amt = (s_amt * row_sign).reshape(b, q)
    col_amt = (s_amt * col_sign).reshape(b, q)

    x = _shift_crop(x, row_amt, aug['y0'], ps, dim=1)   # (B, ps, win, Q, 3)
    x = _shift_crop(x, col_amt, aug['x0'], ps, dim=2)   # (B, ps, ps, Q, 3)

    # RandomRotate: the spatial map, then the (stack, view) relabel
    zero = torch.zeros(b, dtype=torch.int64, device=dev)
    ry, rx = _rot_index(aug['rot_k'], ps)
    x = _crop_rotate(x.reshape(b, ps, ps, q * 3), zero, zero, ry, rx)
    qin = torch.as_tensor(_relabel_table(views), device=dev)[aug['rot_k']]
    x = torch.gather(x.reshape(b, ps, ps, q, 3), 3,
                     qin[:, None, None, :, None].expand(b, ps, ps, q, 3))

    # RedistColor, Brightness, then Contrast on the h-stack mean
    x = torch.einsum('byxqc,bdc->byxqd', x.float(), aug['color'])
    x = x * aug['brightness'][:, None, None, None, None]
    contrast = aug['contrast'][:, None, None, None, None]
    pivot = torch.mean(x[:, :, :, :views], dim=(1, 2, 3, 4),
                       keepdim=True) * (1.0 - contrast)
    x = x * contrast + pivot

    out = x.permute(0, 3, 4, 1, 2).reshape(b, q * 3, ps, ps)
    n3 = views * 3
    return tuple(out[:, s * n3:(s + 1) * n3] for s in range(N_STACKS))


def augment_targets(aux: torch.Tensor, mpi, aug: dict, ps: int,
                    planes: int):
    """gt / mask / MPI side of the chain: shift correction, crop, rotation
    (the mask is not rotated).  ``aux`` is ``(B, win, win*8)``; ``mpi``
    ``(B, win, win*64)`` or None.  Returns ``gt (B, ps, ps)``, ``mpi
    (B, planes, ps, ps, 5)`` or None, ``mask (B, ps, ps)`` int32."""
    b, win = aux.shape[0], aux.shape[1]
    aux = aux.reshape(b, win, win, -1)
    ry, rx = _rot_index(aug['rot_k'], ps)
    ar = torch.arange(ps, device=aux.device)
    iy, ix = ar[None, :, None].expand(1, ps, ps), ar[None, None, :].expand(
        1, ps, ps)

    shift = aug['shift']
    gt = _crop_rotate(aux[..., :1], aug['y0'], aug['x0'], ry, rx)[..., 0]
    gt = gt - shift[:, None, None]
    mask = _crop_rotate(aux[..., 1:2], aug['y0'], aug['x0'], iy, ix)[..., 0]
    mask = mask.to(torch.int32)
    if mpi is None:
        return gt, None, mask

    mpi = mpi.reshape(b, win, win, -1)[..., :planes * 5]
    mpi = _crop_rotate(mpi, aug['y0'], aug['x0'], ry, rx)
    mpi = mpi.reshape(b, ps, ps, planes, 5)
    # disparity channel: subtract the sample's shift
    mpi = torch.cat([mpi[..., :4], mpi[..., 4:] - shift[:, None, None, None,
                                                          None]], dim=-1)
    return gt, mpi.permute(0, 3, 1, 2, 4), mask
