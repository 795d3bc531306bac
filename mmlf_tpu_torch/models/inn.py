"""The invertible network (INN): coupling blocks and the zixel GMM readout.

The PyTorch counterpart of ``mmlf_tpu.models.inn`` (``--model_inn``), on
NCHW activations:

  * ``AIOCouplingBlock``: the channel split ``C//2 | C - C//2``, two affine
    couplings whose log-scales are ``clamp·tanh(0.2·s)`` of a ``Subnet``,
    a per-channel actnorm (SOFTPLUS ``0.2·logaddexp(0, 0.5a)``, SIGMOID
    ``10·sigmoid(a - 2)`` or EXP ``exp(a)``) and a fixed channel
    permutation (a hard permutation, or a random rotation under
    ``--model_soft_permutation``); the log-det is accumulated exactly.
    The JAX package applies the actnorm and ``x @ w`` on the last
    (channel) axis; here they act on dim 1.  The permutation is a
    persistent buffer (``perm``): in the checkpoint, out of the optimizer,
    as the JAX package's ``stop_gradient`` leaves it.
  * ``Subnet``: Conv(k, pad k//2) → ReLU → Conv(k, pad k//2 - 1) → BN →
    ReLU.  Its BatchNorm is flax's default, momentum 0.99, i.e. torch's
    momentum 0.01 (not ``model_batchnorm_momentum``), biased running
    variance, eps 1e-5 (``ops/batchnorm.BatchNorm2d``, whose statistics
    are the global batch's under ``--mesh_data``).  Under ``--bf16`` its
    convs take bf16 input and weights and add the bias in bf16 (flax's
    ``dtype``); BatchNorm and everything outside the subnet stay fp32.
  * ``INN``: the four view streams with h/v and i/d weight sharing (h/v
    only under ``--model_cross``), the horizontal stream with H and W
    swapped, the increasing diagonal swapped and mirrored, mapped back
    before the channel concat, ``out_blocks`` blocks on the merged
    zixels, and the readout: squared distances to the trainable centres
    ``mu``, the min-distance one-hot (ties give several ones) →
    ``class_to_reg`` mean, the softmax posterior and its moment
    ``logvar``.  ``jac`` is normalised by ``dims·H·W`` here and again in
    the IB loss (``losses.information_bottleneck``), as in the JAX
    package.

Inputs are view stacks ``(b, n, H, W, 3)`` or, with ``folded=True``, the
training pipeline's ``(b, n·3, H, W)`` (view-major channels, the JAX
package's fold).  Outputs keep the JAX package's layouts: ``zixels``,
``dists``, ``nll``, ``one_hot`` and ``posterior`` channel-last ``(b, H,
W, K)``, ``mean`` / ``logvar`` ``(b, H, W)``, ``jac`` ``(b,)``, ``mu``
``(1, K, K)``.  ``init_inn_`` draws the port's own initial weights from a
seed (not flax's bits); parity tests carry weights across with
``utils/convert.state_dict_from_jax``.
"""

from __future__ import annotations

import numpy as np
import torch
from torch import nn
from torch.nn import functional as F

from ..ops.batchnorm import BatchNorm2d
from ..ops.codecs import bin_centers, class_to_reg
from .feed_forward import _fold

# flax's nn.BatchNorm default momentum 0.99, as torch's convention
SUBNET_BN_MOMENTUM = 0.01
# the subnet convs' init: kaiming-normal (fan-in, gain sqrt 2) times this
SUBNET_INIT_SCALE = 0.035


class Subnet(nn.Module):
    """Conv(k, pad k//2) → ReLU → Conv(k, pad k//2 - 1) → BN → ReLU."""

    def __init__(self, cin: int, cout: int, ksize: int = 2,
                 bf16: bool = False):
        super().__init__()
        p1 = ksize // 2
        p2 = p1 if ksize % 2 == 1 else p1 - 1
        self.conv1 = nn.Conv2d(cin, cout, ksize, padding=p1)
        self.conv2 = nn.Conv2d(cout, cout, ksize, padding=p2)
        self.bn = BatchNorm2d(cout, momentum=SUBNET_BN_MOMENTUM)
        self.dtype = torch.bfloat16 if bf16 else torch.float32

    def _conv(self, conv: nn.Conv2d, x):
        if self.dtype == torch.float32:
            return conv(x)
        # flax Conv(dtype=bf16): bf16 operands, the bias added in bf16
        return F.conv2d(x.to(self.dtype), conv.weight.to(self.dtype), None,
                        conv.stride, conv.padding) + \
            conv.bias.to(self.dtype)[:, None, None]

    def forward(self, x):
        x = F.relu(self._conv(self.conv1, x))
        x = self._conv(self.conv2, x)
        return F.relu(self.bn(x.float()))


class AIOCouplingBlock(nn.Module):
    """Affine coupling + actnorm + fixed permutation on ``(b, C, H, W)``;
    ``forward(x, rev)`` returns ``(y, logdet)``, logdet ``(b,)``."""

    def __init__(self, channels: int, ksize: int = 2, clamp: float = 0.7,
                 act_norm: float = 0.7, act_norm_type: str = 'SOFTPLUS',
                 permute_soft: bool = False, bf16: bool = False):
        super().__init__()
        c = channels
        self.len1, self.len2 = c // 2, c - c // 2
        self.clamp = clamp
        self.act_norm = act_norm
        self.act_norm_type = act_norm_type
        self.permute_soft = permute_soft
        if act_norm_type not in ('SOFTPLUS', 'SIGMOID', 'EXP'):
            raise ValueError('act_norm_type must be SOFTPLUS, SIGMOID or EXP')
        self.s1 = Subnet(self.len1, 2 * self.len2, ksize, bf16)
        self.s2 = Subnet(self.len2, 2 * self.len1, ksize, bf16)
        self.act_scale = nn.Parameter(torch.empty(c))
        self.act_offset = nn.Parameter(torch.empty(c))
        self.register_buffer('perm', torch.eye(c))

    def act_scale_init(self) -> float:
        if self.act_norm_type == 'SOFTPLUS':
            return 10.0 * self.act_norm
        return float(np.log(self.act_norm))

    def _scale(self):
        a = self.act_scale
        if self.act_norm_type == 'SOFTPLUS':
            # torch Softplus(beta=0.5) scaled by 0.1
            return 0.1 * 2.0 * torch.logaddexp(torch.zeros_like(a), 0.5 * a)
        if self.act_norm_type == 'SIGMOID':
            return 10.0 * torch.sigmoid(a - 2.0)
        return torch.exp(a)

    def _log_e(self, s):
        return self.clamp * torch.tanh(0.2 * s)

    @staticmethod
    def _mix(x, w):
        """``x @ w`` on the channel dim: out[d] = Σ_c x[c]·w[c, d]."""
        return torch.einsum('bchw,cd->bdhw', x, w)

    def forward(self, x, rev: bool = False):
        w = self.perm
        scale = self._scale()
        n_pix = x.shape[2] * x.shape[3]
        perm_jac = n_pix * torch.sum(torch.log(scale + 1e-12))
        col = (slice(None), None, None)
        l1, l2 = self.len1, self.len2

        if rev:
            # undo permute + actnorm, then the couplings in reverse order
            x = (self._mix(x, w.t()) - self.act_offset[col]) / scale[col]
            x1, x2 = x[:, :l1], x[:, l1:]
            a2 = self.s2(x2)
            lg2 = self._log_e(a2[:, :l1])
            y1 = (x1 - a2[:, l1:]) * torch.exp(-lg2)
            a1 = self.s1(y1)
            lg1 = self._log_e(a1[:, :l2])
            y2 = (x2 - a1[:, l2:]) * torch.exp(-lg1)
            logdet = -(lg1.sum((1, 2, 3)) + lg2.sum((1, 2, 3))) - perm_jac
            return torch.cat([y1, y2], dim=1), logdet

        x1, x2 = x[:, :l1], x[:, l1:]
        a1 = self.s1(x1)
        lg1 = self._log_e(a1[:, :l2])
        y2 = x2 * torch.exp(lg1) + a1[:, l2:]
        a2 = self.s2(y2)
        lg2 = self._log_e(a2[:, :l1])
        y1 = x1 * torch.exp(lg2) + a2[:, l1:]
        y = torch.cat([y1, y2], dim=1)
        y = self._mix(y * scale[col] + self.act_offset[col], w)
        logdet = lg1.sum((1, 2, 3)) + lg2.sum((1, 2, 3)) + perm_jac
        return y, logdet


def _unfold(x, n: int):
    """(b, n·3, H, W) -> (b, n, H, W, 3)."""
    b, nc, h, w = x.shape
    return x.reshape(b, n, nc // n, h, w).permute(0, 1, 3, 4, 2)


class INN(nn.Module):
    """The invertible model and its zixel readout; construct with
    ``INN.from_config(cfg)``; called like ``FeedForward``."""

    def __init__(self, views: int = 9, in_blocks: int = 3,
                 out_blocks: int = 8, ksize: int = 2, cross: bool = False,
                 clamp: float = 0.7, act_norm: float = 0.7,
                 act_norm_type: str = 'SOFTPLUS', permute_soft: bool = False,
                 disp_min: float = -3.5, disp_max: float = 3.5,
                 bf16: bool = False):
        super().__init__()
        self.views = views
        self.in_blocks, self.out_blocks = in_blocks, out_blocks
        self.ksize = ksize
        self.cross = cross
        self.disp_min, self.disp_max = disp_min, disp_max
        kw = dict(ksize=ksize, clamp=clamp, act_norm=act_norm,
                  act_norm_type=act_norm_type, permute_soft=permute_soft,
                  bf16=bf16)
        c = views * 3
        # h/v and i/d streams share weights
        self.in_net_hv = nn.ModuleList(AIOCouplingBlock(c, **kw)
                                       for _ in range(in_blocks))
        self.in_net_id = None if cross else nn.ModuleList(
            AIOCouplingBlock(c, **kw) for _ in range(in_blocks))
        self.out_net = nn.ModuleList(AIOCouplingBlock(self.dims, **kw)
                                     for _ in range(out_blocks))
        self.mu = nn.Parameter(torch.empty(1, self.dims, self.dims))

    @property
    def dims(self) -> int:
        return (2 if self.cross else 4) * self.views * 3

    @classmethod
    def from_config(cls, cfg) -> 'INN':
        return cls(views=cfg.model_views, in_blocks=cfg.model_in_blocks,
                   out_blocks=cfg.model_out_blocks, ksize=cfg.model_ksize,
                   cross=cfg.model_cross, clamp=cfg.model_clamp,
                   act_norm=cfg.model_act_norm,
                   act_norm_type=cfg.model_act_norm_type,
                   permute_soft=cfg.model_soft_permutation,
                   disp_min=cfg.val_disp_min, disp_max=cfg.val_disp_max,
                   bf16=cfg.bf16)

    @staticmethod
    def _stream(blocks, x, rev: bool = False):
        logdet = torch.zeros(x.shape[0], device=x.device)
        for blk in (reversed(blocks) if rev else blocks):
            x, j = blk(x, rev=rev)
            logdet = logdet + j
        return x, logdet

    def forward(self, h_views, v_views, i_views=None, d_views=None,
                folded: bool = False):
        def fold(s):
            return (s if folded else _fold(s)).float()

        xs = [fold(h_views), fold(v_views)]
        if xs[0].shape[1] != self.views * 3:
            raise ValueError(
                f'INN is built for {self.views} views but the input stack '
                f'has {xs[0].shape[1] // 3} (the coupling splits are static: '
                f'model_views must match the dataset)')
        hw = xs[0].shape[2] * xs[0].shape[3]
        # the horizontal stream with H and W swapped, mapped back
        zh, jh = self._stream(self.in_net_hv, xs[0].transpose(2, 3))
        zv, jv = self._stream(self.in_net_hv, xs[1])
        parts, logdet = [zh.transpose(2, 3), zv], jh + jv
        if not self.cross:
            # the increasing diagonal swapped, then mirrored
            zi, ji = self._stream(self.in_net_id,
                                  fold(i_views).transpose(2, 3).flip(-1))
            zd, jd = self._stream(self.in_net_id, fold(d_views))
            parts += [zi.flip(-1).transpose(2, 3), zd]
            logdet = logdet + ji + jd
        z, jo = self._stream(self.out_net, torch.cat(parts, dim=1))
        jac = (logdet + jo) / float(self.dims * hw)
        return self._readout(z.permute(0, 2, 3, 1), jac)

    def _readout(self, zixels, jac):
        """The GMM readout of channel-last zixels ``(b, H, W, D)``."""
        mu = self.mu[0]                                      # (K, D)
        zz = torch.sum(zixels ** 2, dim=-1, keepdim=True)
        zm = torch.einsum('bhwd,kd->bhwk', zixels, mu)
        mm = torch.sum(mu ** 2, dim=-1)
        dists = zz - 2.0 * zm + mm                           # (b, H, W, K)

        k = dists.shape[-1]
        one_hot = (torch.amin(dists, dim=-1, keepdim=True) == dists).float()
        nll = (0.5 * dists - jac[:, None, None, None]) / float(k)
        mean = class_to_reg(one_hot, self.disp_min, self.disp_max, k)
        posterior = torch.softmax(-0.5 * dists, dim=-1)
        bins = bin_centers(self.disp_min, self.disp_max, k, dists.device)
        logvar = torch.log(torch.sum((bins - mean[..., None]) ** 2
                                     * posterior, dim=-1))
        return {'zixels': zixels, 'jac': jac, 'mu': self.mu,
                'dists': dists, 'nll': nll, 'one_hot': one_hot,
                'mean': mean, 'logvar': logvar, 'posterior': posterior,
                'scores': None}

    def inverse(self, zixels):
        """The four view stacks ``(b, n, H, W, 3)`` that give the
        channel-last ``zixels`` (eval-mode BN: call in ``eval()``)."""
        z, _ = self._stream(self.out_net, zixels.permute(0, 3, 1, 2),
                            rev=True)
        c = self.views * 3
        zh, _ = self._stream(self.in_net_hv, z[:, :c].transpose(2, 3),
                             rev=True)
        zv, _ = self._stream(self.in_net_hv, z[:, c:2 * c], rev=True)
        out = [zh.transpose(2, 3), zv]
        if not self.cross:
            zi, _ = self._stream(self.in_net_id,
                                 z[:, 2 * c:3 * c].transpose(2, 3).flip(-1),
                                 rev=True)
            zd, _ = self._stream(self.in_net_id, z[:, 3 * c:], rev=True)
            out += [zi.flip(-1).transpose(2, 3), zd]
        return tuple(_unfold(x, self.views) for x in out)


@torch.no_grad()
def init_inn_(model: INN, seed: int = 0) -> INN:
    """The JAX package's initial distributions, drawn from ``seed`` with
    a ``torch.Generator`` (not JAX's bits), in place: subnet convs
    kaiming-normal × 0.035 with zero biases, BN 1/0 and running 0/1,
    actnorm scale at its type's initial value and offset 0, a random
    permutation (or a random rotation, det +1, under soft permutation),
    centres ``mu`` standard normal."""
    gen = torch.Generator(device='cpu').manual_seed(seed)
    for m in model.modules():
        if isinstance(m, nn.Conv2d):
            fan_in = m.weight[0].numel()
            std = (2.0 / fan_in) ** 0.5 * SUBNET_INIT_SCALE
            m.weight.copy_(torch.randn(m.weight.shape, generator=gen) * std)
            m.bias.zero_()
        elif isinstance(m, nn.BatchNorm2d):
            m.reset_parameters()
        elif isinstance(m, AIOCouplingBlock):
            c = m.perm.shape[0]
            m.act_scale.fill_(m.act_scale_init())
            m.act_offset.zero_()
            if m.permute_soft:
                q, r = torch.linalg.qr(torch.randn(c, c, generator=gen,
                                                   dtype=torch.float64))
                q = q * torch.sign(torch.diagonal(r))
                q[:, 0] *= torch.sign(torch.linalg.det(q))
                m.perm.copy_(q.float())
            else:
                m.perm.copy_(torch.eye(c)[torch.randperm(c, generator=gen)])
    model.mu.copy_(torch.randn(model.mu.shape, generator=gen))
    return model
