"""EPINET-style multi-stream CNN for light-field depth estimation.

The PyTorch counterpart of ``mmlf_tpu.models.feed_forward.FeedForward``,
eval and train forward:

  * public inputs are view stacks ``(b, n, H, W, 3)``, folded to NCHW
    ``(b, n*3, H, W)`` with view-major channel order (view*3 + colour);
    ``folded=True`` takes stacks already in that layout (the training
    input pipeline emits it, ``data/augment2.py``);
  * one shared-weight input net for the horizontal+vertical streams and one
    for the two diagonals.  Orientation is normalized on the activations,
    as the reference does: the horizontal stream (``'t'``) runs with H and
    W swapped, the increasing diagonal (``'tf'``) swapped and then mirrored
    along the original H axis.  (The JAX package folds the same transforms
    into the kernels instead.)
  * ``ksize=2`` blocks pad (1,1) on the first conv and (0,0) on the second,
    so the size goes 512 → 513 → 512, as torch's ``k//2`` / ``k//2 - 1``;
  * module names give the reference state-dict keys
    (``in_net_hv.<b>.0/2/3``, ``in_net_id.…``, ``out_net.…``), so a
    reference ``checkpoint.pt`` loads strictly.

Heads:
  BASE — 1-channel ``mean``;
  UPR (``uncert``) — ``mean`` + ``logvar``, plus a Laplace posterior over
      ``steps`` bins with exp(logvar) as the Laplace *scale* (reference
      quirk, kept);
  DPP (``discrete``) — ``steps`` logits, softmax posterior, argmax one-hot
      → ``class_to_reg`` mean, posterior-variance logvar.

BatchNorm is ``ops/batchnorm.BatchNorm2d``: in train mode it normalizes
with the batch statistics and keeps the biased variance in its running
stats, with ``model_batchnorm_momentum`` as torch's momentum.
``init_default_`` gives the JAX package's initial distributions
(lecun-normal convs, zero biases, BN 1/0, running stats 0/1).

``pallas_trunk`` (``--pallas_trunk``) runs the streams and the out_net of a
``ksize=2`` net in train mode through kernel K3 (``models/pallas_trunk.py``),
with the same weights, BN buffers and heads; eval keeps the plain path, as
the JAX package does.

``unet`` (``--model_unet``) replaces the out_net by the U-Net of
``models/unet.py`` (depth 5, wf 6, padded convs, BatchNorm), named
``out_net`` as in the reference; ``pallas_trunk`` is then ignored and the
U-Net does not rematerialize, as in the JAX package.

``bf16`` (``--bf16``) runs the conv trunk in bfloat16 where the JAX package
rounds: the stacks are cast at entry, each conv takes bf16 input and bf16
weights and adds its bias in bf16 after the conv (two roundings, not one
inside the convolution), BatchNorm normalizes in bf16 (``ops/batchnorm``),
and the trunk's output is cast to float32 before the heads.  Parameters,
heads, the posterior and the optimizer stay float32.  ``remat``
(``--remat``) recomputes each train-mode conv block in the backward
(``torch.utils.checkpoint``) instead of keeping its activations; eval and
the fused trunk ignore it.
"""

from __future__ import annotations

import contextlib

import torch
from torch import nn
from torch.nn import functional as F
from torch.utils.checkpoint import checkpoint

from ..ops.batchnorm import BatchNorm2d, recomputing
from ..ops.codecs import bin_centers, class_to_reg
from ..trace import span
from .invertible import NOT_SUPPORTED_MSG
from .pallas_trunk import trunk_forward
from .unet import UNet


def laplacian(x: torch.Tensor, mu: torch.Tensor, b: torch.Tensor):
    """Laplace density over the last (bin) axis.

    :param x: ``(S,)`` evaluation points (bin grid)
    :param mu: ``(...)`` location
    :param b: ``(...)`` scale (the reference passes *variance* — quirk)
    """
    mu = mu[..., None]
    b = b[..., None]
    return 1.0 / (2.0 * b) * torch.exp(-torch.abs(x - mu) / b)


def conv_block(cin: int, cout: int, ksize: int, use_bn: bool,
               out_bn_relu: bool = True,
               bn_momentum: float = 0.1) -> nn.Sequential:
    """[Conv(k) → ReLU → Conv(k) → (BN) → (ReLU)] with shape-preserving
    pads; indices 0 and 2 are the convs and 3 the BN, as in the reference.
    ``bn_momentum`` is torch's convention (flax's is ``1 - this``)."""
    p1 = ksize // 2
    p2 = p1 if ksize % 2 == 1 else p1 - 1
    layers = [nn.Conv2d(cin, cout, ksize, padding=p1), nn.ReLU(),
              nn.Conv2d(cout, cout, ksize, padding=p2)]
    if out_bn_relu:
        if use_bn:
            layers.append(BatchNorm2d(cout, momentum=bn_momentum))
        layers.append(nn.ReLU())
    return nn.Sequential(*layers)


def _fold(stack: torch.Tensor) -> torch.Tensor:
    """(b, n, H, W, 3) -> (b, n*3, H, W), view-major channel order."""
    b, n, h, w, c = stack.shape
    return stack.permute(0, 1, 4, 2, 3).reshape(b, n * c, h, w)


class FeedForward(nn.Module):
    """The four-stream light-field depth CNN.

    Construct via ``FeedForward.from_config(cfg)``; call with view stacks
    ``(b, n, H, W, 3)`` (or, with ``folded=True``, ``(b, n*3, H, W)``).
    ``.train()`` selects batch-statistics BatchNorm.  Returns ``{'mean',
    'logvar', 'scores', 'one_hot', 'posterior'}`` with the JAX package's
    layouts (bins last).
    """

    def __init__(self, ksize: int = 2, in_blocks: int = 3,
                 out_blocks: int = 8, chs: int = 70, views: int = 9,
                 cross: bool = False, uncert: bool = False,
                 discrete: bool = False, unet: bool = False,
                 no_batchnorm: bool = False,
                 batchnorm_momentum: float = 0.1,
                 disp_min: float = -3.5, disp_max: float = 3.5,
                 pallas_trunk: bool = False, bf16: bool = False,
                 remat: bool = False):
        super().__init__()
        self.ksize = ksize
        self.pallas_trunk = pallas_trunk
        self.dtype = torch.bfloat16 if bf16 else torch.float32
        self.remat = remat
        self.cross = cross
        self.uncert = uncert
        self.discrete = discrete
        self.unet = unet
        self.views = views
        self.disp_min = disp_min
        self.disp_max = disp_max
        use_bn = not no_batchnorm

        def stream_net():
            return nn.Sequential(*[
                conv_block(views * 3 if b == 0 else chs, chs, ksize, use_bn,
                           bn_momentum=batchnorm_momentum)
                for b in range(in_blocks)])

        self.in_net_hv = stream_net()
        self.in_net_id = None if cross else stream_net()

        cat_chs = (2 if cross else 4) * chs
        out_chs = 1
        if uncert:
            out_chs = 2
        elif discrete:
            out_chs = self.steps
        if unet:
            self.out_net = UNet(cat_chs, out_chs, depth=5, wf=6,
                                padding=True, batch_norm=True)
        else:
            self.out_net = nn.Sequential(
                *[conv_block(cat_chs, cat_chs, ksize, use_bn,
                             bn_momentum=batchnorm_momentum)
                  for _ in range(out_blocks - 1)],
                conv_block(cat_chs, out_chs, ksize, use_bn,
                           out_bn_relu=False))

    @classmethod
    def from_config(cls, cfg) -> 'FeedForward':
        if getattr(cfg, 'model_invertible', False):
            raise NotImplementedError(NOT_SUPPORTED_MSG)
        if getattr(cfg, 'model_inn', False):
            raise ValueError('an INN config builds models/inn.INN '
                             '(models.build_model)')
        return cls(ksize=cfg.model_ksize, in_blocks=cfg.model_in_blocks,
                   out_blocks=cfg.model_out_blocks, chs=cfg.model_chs,
                   views=cfg.model_views, cross=cfg.model_cross,
                   uncert=cfg.model_uncert, discrete=cfg.model_discrete,
                   unet=cfg.model_unet, no_batchnorm=cfg.model_no_batchnorm,
                   batchnorm_momentum=cfg.model_batchnorm_momentum,
                   disp_min=cfg.val_disp_min, disp_max=cfg.val_disp_max,
                   pallas_trunk=cfg.pallas_trunk, bf16=cfg.bf16,
                   remat=cfg.remat)

    @property
    def steps(self) -> int:
        return (2 if self.cross else 4) * self.views * 3

    def forward(self, h_views, v_views, i_views=None, d_views=None,
                folded: bool = False):
        def fold(s):
            return (s if folded else _fold(s)).to(self.dtype)

        if self.pallas_trunk and self.ksize == 2 and self.training and \
                not self.unet:
            stacks = [fold(s) for s in (h_views, v_views)] + (
                [] if self.cross else [fold(i_views), fold(d_views)])
            output = trunk_forward(self, *stacks)
        else:
            output = self._plain_trunk(fold, h_views, v_views, i_views,
                                       d_views)
        with span('mmlf.model.head'):
            output = output.float()
            mean = output[:, 0]

            scores = one_hot = posterior = logvar = None
            bins = bin_centers(self.disp_min, self.disp_max, self.steps,
                               output.device)

            if self.discrete:
                scores = output.permute(0, 2, 3, 1)            # (b, H, W, S)
                one_hot = (torch.amax(scores, dim=-1, keepdim=True)
                           == scores).float()
                posterior = torch.exp(scores)
                posterior = posterior / torch.sum(posterior, -1,
                                                  keepdim=True)
                mean = class_to_reg(one_hot, self.disp_min, self.disp_max,
                                    self.steps)
                var = torch.sum((bins - mean[..., None]) ** 2.0 * posterior,
                                dim=-1)
                logvar = torch.log(var)

            if self.uncert:
                logvar = output[:, 1]
                # reference quirk: exp(logvar) is the Laplace *scale*, not var
                posterior = laplacian(bins, mean, torch.exp(logvar))

        return {'mean': mean, 'logvar': logvar, 'scores': scores,
                'one_hot': one_hot, 'posterior': posterior}

    def _plain_trunk(self, fold, h_views, v_views, i_views, d_views):
        net = self._run_net
        # 't': the reference's transpose of the horizontal stream
        x_h = fold(h_views).transpose(2, 3)
        f_h = net(self.in_net_hv, x_h).transpose(2, 3)
        f_v = net(self.in_net_hv, fold(v_views))
        feats = [f_h, f_v]
        if not self.cross:
            # 'tf': transpose, then mirror the original-H axis (now last)
            x_i = fold(i_views).transpose(2, 3).flip(-1)
            f_i = net(self.in_net_id, x_i).flip(-1).transpose(2, 3)
            f_d = net(self.in_net_id, fold(d_views))
            feats += [f_i, f_d]
        if self.unet:
            return self.out_net(torch.cat(feats, dim=1))
        return net(self.out_net, torch.cat(feats, dim=1))

    def _run_net(self, blocks: nn.Sequential, x):
        """The conv blocks of one net on ``x`` (in the trunk dtype), each
        checkpointed under ``remat`` in train mode."""
        remat = self.remat and self.training and torch.is_grad_enabled()
        for blk in blocks:
            fn = blk if self.dtype == torch.float32 else \
                (lambda a, blk=blk: _block_bf16(blk, a))
            x = checkpoint(fn, x, use_reentrant=False,
                           context_fn=_recompute_context) if remat else fn(x)
        return x


def _block_bf16(blk: nn.Sequential, x):
    """One conv block on a bf16 activation, rounding where the JAX
    package's ``OrientedConv`` does: the conv of bf16 input and bf16
    weights, then its bias added in bf16."""
    for layer in blk:
        if isinstance(layer, nn.Conv2d):
            x = F.conv2d(x, layer.weight.to(x.dtype), None, layer.stride,
                         layer.padding) + layer.bias.to(x.dtype)[:, None, None]
        else:
            x = layer(x)
    return x


def _recompute_context():
    """``checkpoint``'s contexts: the first forward as it is, the
    recomputation under ``recomputing`` (BN statistics untouched)."""
    return contextlib.nullcontext(), recomputing()


# flax's lecun_normal: a normal truncated at two standard deviations,
# rescaled so the truncated distribution has variance 1 / fan_in
_TRUNC_STD = 0.87962566103423978


@torch.no_grad()
def init_default_(model: nn.Module, seed: int = 0) -> nn.Module:
    """The JAX package's initial weights, drawn from ``seed``, in place.

    The distributions of ``mmlf_tpu`` (flax): lecun-normal conv and
    transposed-conv kernels (truncated normal, variance 1 / fan_in, the
    fan-in of a transposed conv its input channels × taps), zero biases,
    BN scale 1 and bias 0, running mean 0 and variance 1.  The draws come
    from a ``torch.Generator`` seeded with ``seed``, so they are not JAX's
    bits.
    """
    gen = torch.Generator(device='cpu').manual_seed(seed)
    for m in model.modules():
        if isinstance(m, (nn.Conv2d, nn.ConvTranspose2d)):
            w = torch.empty(m.weight.shape, dtype=torch.float32)
            # OIHW, or (in, out, kh, kw) for a transposed conv
            fan_in = w[0].numel() if isinstance(m, nn.Conv2d) else \
                w.shape[0] * w.shape[2] * w.shape[3]
            std = (1.0 / fan_in) ** 0.5 / _TRUNC_STD
            nn.init.trunc_normal_(w, std=std, a=-2.0 * std, b=2.0 * std,
                                  generator=gen)
            m.weight.copy_(w)
            m.bias.zero_()
        elif isinstance(m, nn.BatchNorm2d):
            m.reset_parameters()
    return model


@torch.no_grad()
def init_live_(model: nn.Module, seed: int = 0) -> nn.Module:
    """Random weights that keep the net input-sensitive, in place.

    Kaiming-normal convs, 0.1-scale biases and BN affines, BN running stats
    near identity — the scheme of the JAX package's parity tests.  Small
    uniform weights would attenuate every input to ~1e-7 through the
    11-block trunk and leave only the bias path to compare.
    """
    gen = torch.Generator(device='cpu').manual_seed(seed)

    def randn(p):
        return torch.randn(p.shape, generator=gen, dtype=p.dtype)

    def rand(p):
        return torch.rand(p.shape, generator=gen, dtype=p.dtype)

    for p in model.parameters():
        if p.ndim == 4:
            fan_in = p.shape[1] * p.shape[2] * p.shape[3]
            p.copy_(randn(p) * (2.0 / fan_in) ** 0.5)
        else:
            p.copy_(randn(p) * 0.1)
    for m in model.modules():
        if isinstance(m, nn.BatchNorm2d):
            m.weight.copy_(rand(m.weight) * 0.5 + 0.75)
            m.running_mean.copy_(randn(m.running_mean) * 0.1)
            m.running_var.copy_(rand(m.running_var) * 0.5 + 0.75)
    return model
