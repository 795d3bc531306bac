"""The conv trunk of ``FeedForward`` run through kernel K3 (``--pallas_trunk``).

The counterpart of ``mmlf_tpu/models/pallas_trunk.py`` (``PallasStreamNet``
and ``PallasOutNet``).  It executes the port's own modules: the weights are
those of the ``nn.Sequential`` conv blocks (indices 0 and 2 the convs, 3 the
BatchNorm), so the state dict and the weight conversions stay as they are.

Every block is one call of ``ops/kernels/conv_block.fused_double_conv``.
A block's BatchNorm is computed from the kernel's per-channel sums
(``BatchNorm2d.affine_from_sums``: biased variance, running statistics
updated) and applied, with its ReLU, in the NEXT block's input stage, so
the chain stores one activation per block (its raw ``y2``).  Each stream
returns its raw last ``y2`` with that block's BN affine; the four streams
are concatenated on channels and out_net block 0 applies their BN + ReLU.
The last out_net block has no BN or ReLU and returns its ``y2``.

Orientation: the plain path transposes (and mirrors) the activations of the
``'t'`` and ``'tf'`` streams; here the 2×2 kernels are re-oriented instead
(``orient_kernel``), outside the autograd Function, so the weight gradients
flow back through the re-indexing.

Training path only: ``FeedForward`` takes it in train mode with
``pallas_trunk`` and ``ksize == 2``; eval keeps the plain path.

Under ``--bf16`` the stacks arrive in bfloat16, so the canvases between
blocks (each block's y2, the residuals K3 saves) are bf16 and K3 runs its
bf16 instance; the BN affines and the sums stay float32.  ``--remat`` is
accepted and ignored, as by the JAX package's ``PallasOutNet``: K3 saves
only its input and y2 and recomputes y1 in the backward already.
"""

from __future__ import annotations

import torch
from torch import nn

from ..ops.kernels.conv_block import fused_double_conv


def orient_kernel(w: torch.Tensor, orientation: str) -> torch.Tensor:
    """An OIHW kernel re-oriented for a stream: ``'t'`` swaps H and W,
    ``'tf'`` swaps and then flips the new H axis, ``'n'`` keeps it.  The
    pads (1, 1) and (0, 0) are symmetric, so no pad swap is needed."""
    if orientation in ('t', 'tf'):
        w = w.transpose(2, 3)
    if orientation == 'tf':
        w = w.flip(2)
    return w


def _identity_affine(c: int, like: torch.Tensor):
    # the input affine is float32 whatever the canvases' dtype
    return (torch.ones(c, dtype=torch.float32, device=like.device),
            torch.zeros(c, dtype=torch.float32, device=like.device))


def run_blocks(blocks, x, si, ti, relu_in: bool, affine_in: bool,
               orientation: str = 'n'):
    """Run ``blocks`` (``conv_block`` Sequentials) through K3.

    Returns the last block's raw ``y2`` and the input affine the next stage
    applies: its BN ``(scale, shift)`` with ``affine_in=True`` after a BN
    block, ones/zeros with ``affine_in=False`` without BN (the ReLU stays,
    ``relu_in=True``).  For a block without BN+ReLU (the out_net's last) the
    affine is ``None``.
    """
    count = float(x.shape[0] * x.shape[2] * x.shape[3])
    for blk in blocks:
        conv1, conv2 = blk[0], blk[2]
        y2, ps, pss = fused_double_conv(
            x, si, ti, orient_kernel(conv1.weight, orientation), conv1.bias,
            orient_kernel(conv2.weight, orientation), conv2.bias, relu_in,
            affine_in)
        x, relu_in = y2, True
        if len(blk) == 3:                      # no BN, no ReLU: the last
            si = ti = None
        elif len(blk) == 5:                    # conv, relu, conv, BN, relu
            si, ti = blk[3].affine_from_sums(ps, pss, count)
            affine_in = True
        else:                                  # conv, relu, conv, relu
            si, ti = _identity_affine(y2.shape[1], y2)
            affine_in = False
    return x, si, ti, affine_in


def trunk_forward(model: nn.Module, x_h, x_v, x_i=None, x_d=None):
    """The four streams and the out_net of ``model`` (a ``FeedForward`` in
    train mode) on folded NCHW stacks; returns the out_net's output
    ``(b, out_chs, H, W)``."""
    streams = [(model.in_net_hv, x_h, 't'), (model.in_net_hv, x_v, 'n')]
    if not model.cross:
        streams += [(model.in_net_id, x_i, 'tf'), (model.in_net_id, x_d, 'n')]
    feats, sis, tis = [], [], []
    for net, x, orientation in streams:
        si, ti = _identity_affine(x.shape[1], x)
        y2, si, ti, affine_in = run_blocks(net, x, si, ti, False, False,
                                           orientation)
        feats.append(y2)
        sis.append(si)
        tis.append(ti)
    out, _, _, _ = run_blocks(model.out_net, torch.cat(feats, dim=1),
                              torch.cat(sis), torch.cat(tis), True,
                              affine_in)
    return out
