"""Plain PyTorch reference of what the cells time: a net's train step
(input path, forward, loss, backward, Adam, BatchNorm statistics) and the
shift-ensemble validation (members, selection, mixture posterior,
metrics).  What a configuration's net adds (its leaves, its head and its
loss) comes from its module under ``nets/`` (``nets.py``); the four k=2
streams and the out_net of conv blocks that the paper's heads share are
here, as ``Net``.

Written from the paper's method and the reference code's conventions, and
imports nothing of the program: it takes the benchmark's scenes and
weights and the batch indices and augmentation draws the program's sampler
made, and works out everything else again in float32 with TF32 off (a
bfloat16 scene cache, where the configuration states one, is rounded as
stated).  ``prec`` makes the control that the limits of ``correct`` must
reject: ``'tf32'`` rounds every conv operand to a 10-bit mantissa (to
nearest even), ``'fp8'`` rounds the operands and the stored activations
to e4m3 and their gradients to e5m2, each with a per-tensor scale.
``fault`` plants one of the faults the limits must also reject.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

EPS_BN = 1e-5
BN_MOMENTUM = 0.1
GUARD_BAND = 8          # the patch starts this far into the crop offset
LOSS_MARGIN = 11        # train mask margin
ADAM = dict(b1=0.9, b2=0.999, eps=1e-8)


# ---------------------------------------------------------------- precision

def _tf32(x: torch.Tensor) -> torch.Tensor:
    """float32 with its mantissa rounded to TF32's 10 bits (to nearest
    even)."""
    i = x.contiguous().view(torch.int32)
    i = (i + (((i >> 13) & 1) + 0x0FFF)) & ~0x1FFF
    return i.view(torch.float32)


def _fp8(x: torch.Tensor, dtype) -> torch.Tensor:
    """float32 through an fp8 format with a per-tensor scale (amax to the
    format's largest finite value)."""
    top = torch.finfo(dtype).max
    scale = top / torch.clamp(x.abs().amax(), min=1e-30)
    return (x * scale).to(dtype).to(torch.float32) / scale


class _Round(torch.autograd.Function):
    """Round a conv operand in the forward and its gradient in the
    backward, so the backward's products take the lower precision too."""

    @staticmethod
    def forward(ctx, x, fwd, bwd):
        ctx.bwd = bwd
        return fwd(x.detach())

    @staticmethod
    def backward(ctx, g):
        return ctx.bwd(g), None, None


def _bf16(x: torch.Tensor) -> torch.Tensor:
    return x.to(torch.bfloat16).to(torch.float32)


def _rounding(fwd, bwd):
    return lambda x: _Round.apply(x, fwd, bwd)


def _ident(x):
    return x


E4M3 = _rounding(lambda t: _fp8(t, torch.float8_e4m3fn),
                 lambda t: _fp8(t, torch.float8_e5m2))
# name -> (conv operands, stored activations): TF32 rounds only what the
# tensor cores read; fp8 (e4m3 values, e5m2 gradients, as fp8 training
# takes them) also the activations a trunk in that type stores
PRECISION = {'fp32': (_ident, _ident),
             'tf32': (_rounding(_tf32, _tf32), _ident),
             'fp8': (E4M3, E4M3)}


def no_tf32():
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False


# ------------------------------------------------------------------ network

def conv_blocks(model: dict, out_chs: int):
    """``(prefix, cin, cout, with_bn)`` of every conv block of ``Net``
    with ``out_chs`` output channels, in the order of its state dict."""
    if model.get('model_ksize', 2) != 2:
        raise ValueError('the benchmark draws k=2 nets only')
    chs, views = model['model_chs'], model['model_views']
    out = []
    for net in ('in_net_hv', 'in_net_id'):
        for b in range(model['model_in_blocks']):
            out.append((f'{net}.{b}', 3 * views if b == 0 else chs, chs,
                        True))
    cat, n = 4 * chs, model['model_out_blocks']
    for b in range(n - 1):
        out.append((f'out_net.{b}', cat, cat, True))
    out.append((f'out_net.{n - 1}', cat, out_chs, False))
    return out


class Net:
    """The paper's four-stream network as functions of a state dict: four
    k=2 streams (a shared net for the horizontal and vertical stacks, one
    for the two diagonals, each of ``in_blocks`` blocks), then the
    ``out_blocks``-block out_net on their concatenation, whose last block
    gives the head's channels (``conv_blocks``).  A block is conv(pad 1) →
    ReLU → conv(pad 0) → BatchNorm → ReLU; the last out_net block ends
    after its second conv.  The horizontal stream runs on the transposed
    stack, the increasing diagonal on the transposed and mirrored one."""

    def __init__(self, model: dict, params: dict, buffers: dict,
                 prec: str = 'fp32', momentum: float = BN_MOMENTUM):
        self.momentum = momentum
        self.in_blocks = model['model_in_blocks']
        self.out_blocks = model['model_out_blocks']
        self.p, self.b = params, buffers
        self.q, self.store = PRECISION[prec]

    def _conv(self, x, w, b, pad):
        """The conv of rounded operands, rounded where the trunk stores
        it, then its bias added (and the sum rounded again)."""
        q, st = self.q, self.store
        return st(st(F.conv2d(q(x), q(w), None, padding=pad)) +
                  q(b)[:, None, None])

    def _block(self, prefix, x, bn, train, update):
        p, st = self.p, self.store
        x = self._conv(x, p[f'{prefix}.0.weight'], p[f'{prefix}.0.bias'], 1)
        x = self._conv(F.relu(x), p[f'{prefix}.2.weight'],
                       p[f'{prefix}.2.bias'], 0)
        if not bn:
            return x
        rm, rv = self.b[f'{prefix}.3.running_mean'], \
            self.b[f'{prefix}.3.running_var']
        if train:
            mean = x.mean((0, 2, 3))
            var = ((x - mean[:, None, None]) ** 2).mean((0, 2, 3))
            if update:
                with torch.no_grad():
                    rm.mul_(1.0 - self.momentum).add_(self.momentum * mean)
                    rv.mul_(1.0 - self.momentum).add_(self.momentum * var)
        else:
            mean, var = rm, rv
        # the normalize as one per-channel affine x·s + t
        scale = p[f'{prefix}.3.weight'] * torch.rsqrt(var + EPS_BN)
        shift = p[f'{prefix}.3.bias'] - mean * scale
        x = st(st(x * st(scale)[:, None, None]) + st(shift)[:, None, None])
        return F.relu(x)

    def _net(self, name, x, train, update):
        for b in range(self.in_blocks):
            x = self._block(f'{name}.{b}', x, True, train, update)
        return x

    def streams(self, h, v, i, d, train: bool, update: bool = False):
        """Folded NCHW stacks ``(B, 3·views, H, W)`` → the four streams'
        features, concatenated ``(B, 4·chs, H, W)``: what an out_net
        reads."""
        h, v, i, d = (self.store(x) for x in (h, v, i, d))
        f_h = self._net('in_net_hv', h.transpose(2, 3), train,
                        update).transpose(2, 3)
        f_v = self._net('in_net_hv', v, train, update)
        f_i = self._net('in_net_id', i.transpose(2, 3).flip(-1), train,
                        update).flip(-1).transpose(2, 3)
        f_d = self._net('in_net_id', d, train, update)
        return torch.cat([f_h, f_v, f_i, f_d], 1)

    def __call__(self, h, v, i, d, train: bool, update: bool = False):
        """Folded NCHW stacks ``(B, 3·views, H, W)`` → the out_net's output
        ``(B, out_chs, H, W)``."""
        x = self.streams(h, v, i, d, train, update)
        for b in range(self.out_blocks):
            x = self._block(f'out_net.{b}', x, b < self.out_blocks - 1,
                            train, update)
        return x


def split_state(sd: dict, device):
    """``(params, buffers)`` float32 copies of a state dict on ``device``:
    params are the conv and BatchNorm affine leaves (with grad), buffers
    the running statistics."""
    params, buffers = {}, {}
    for k, v in sd.items():
        if k.endswith('num_batches_tracked'):
            continue
        t = v.detach().to(device, torch.float32).clone()
        if k.endswith(('running_mean', 'running_var')):
            buffers[k] = t
        else:
            params[k] = t.requires_grad_()
    return params, buffers


# --------------------------------------------------------------- light field

def roll_lerp_views(stack: torch.Tensor, shifts, axis: int) -> torch.Tensor:
    """Shift each view of ``(n, H, W, C)`` by its own sub-pixel amount,
    circularly: ``(1-α)·x[(j - s0) mod L] + α·x[(j - s1) mod L]`` with
    ``s0 = trunc(s)``, ``α = |s - s0|``, ``s1 = s0 + copysign(1, s0)``."""
    s = np.asarray(shifts, np.float32)
    s0 = np.trunc(s)
    alpha = np.abs(s - s0)
    s1 = s0 + np.copysign(np.float32(1.0), s0)
    n, length = stack.shape[0], stack.shape[axis]
    pos = np.arange(length)
    out = []
    for v in range(n):
        i0 = torch.from_numpy((pos - int(s0[v])) % length).to(stack.device)
        i1 = torch.from_numpy((pos - int(s1[v])) % length).to(stack.device)
        dim = stack.ndim + axis - 1
        x = stack[v]
        out.append((1.0 - float(alpha[v])) * x.index_select(dim, i0)
                   + float(alpha[v]) * x.index_select(dim, i1))
    return torch.stack(out)


def shift_stacks(h, v, i, d, disp: float):
    """EPI-shift the four ``(n, H, W, 3)`` stacks by ``disp``: view k moves
    ``disp·(k - n//2)`` pixels, the horizontal stack along W, the vertical
    along H, the increasing diagonal along W and against H, the decreasing
    one along both."""
    n = h.shape[0]
    s = np.float32(disp) * (np.arange(n, dtype=np.float32) - n // 2)
    h = roll_lerp_views(h, s, -2)
    v = roll_lerp_views(v, s, -3)
    i = roll_lerp_views(roll_lerp_views(i, s, -2), -s, -3)
    d = roll_lerp_views(roll_lerp_views(d, s, -2), s, -3)
    return h, v, i, d


def fold(stack: torch.Tensor) -> torch.Tensor:
    """``(…, n, H, W, 3)`` → ``(…, n·3, H, W)``, view-major channels."""
    *lead, n, hh, ww, c = stack.shape
    return stack.movedim(-1, -3).reshape(*lead, n * c, hh, ww)


def _rot(a: torch.Tensor) -> torch.Tensor:
    """One 90° rotation of ``(…, P, P, C)`` maps: out[y, x] = a[x, P-1-y]."""
    return torch.flip(a.transpose(-3, -2), (-3,))


# -------------------------------------------------------------- train step

class TrainScenes:
    """The train scenes as the train step sees them: each stack statically
    shifted by ``train_shift``, gt and the MPI's disparities corrected.
    ``scenes`` holds ``(stacks, gt, mpi, mask)``; the MPI ``(K, H, W, 5)``
    is kept only where ``with_mpi`` (a net whose loss reads it)."""

    def __init__(self, scenes, train_shift: float, bf16: bool = False,
                 with_mpi: bool = False):
        self.scenes = []
        for stacks, gt, mpi, mask in scenes:
            stacks = shift_stacks(*stacks, train_shift) if train_shift else \
                stacks
            if bf16:     # a bfloat16 image cache
                stacks = [_bf16(s) for s in stacks]
            if with_mpi:
                mpi = mpi.clone()
                mpi[..., 4] -= np.float32(train_shift)
            self.scenes.append((stacks, gt - np.float32(train_shift),
                                mpi if with_mpi else None, mask))


def sample_inputs(scenes: TrainScenes, batch, b: int, ps: int, win: int):
    """Sample ``b`` of a drawn batch: its window at the drawn level and
    position, the sub-pixel shift within the window, the crop, the
    rotations, the colour mix, brightness and contrast.  Returns the four
    folded stacks ``(3·views, ps, ps)``, gt, the MPI ``(K, ps, ps, 5)``
    (or None where the scenes keep none; its disparities follow gt's) and
    the mask (not rotated)."""
    stacks, gt, mpi, mask = scenes.scenes[int(batch.scene[b])]
    f = int(batch.factor[b])
    y, x = int(batch.ws_y[b]), int(batch.ws_x[b])
    ys, xs = slice(y, y + win), slice(x, x + win)
    win_stacks = [s[:, ::f, ::f][:, ys, xs] for s in stacks]
    g = (gt[::f, ::f] / np.float32(f))[ys, xs]
    m = mask[::f, ::f][ys, xs]
    if mpi is not None:
        mpi = mpi[:, ::f, ::f][:, ys, xs].clone()
        mpi[..., 4] /= np.float32(f)
    if win_stacks[0].shape[1:3] != (win, win):
        raise ValueError(f'sample {b}: window {win} at ({y}, {x}) leaves '
                         f'the level')
    aug = batch.aug
    shift = float(aug.shift[b])
    h, v, i, d = shift_stacks(*win_stacks, shift)
    g = g - shift
    if mpi is not None:
        mpi[..., 4] -= np.float32(shift)
    y0, x0 = int(aug.y_off[b]) + GUARD_BAND, int(aug.x_off[b]) + GUARD_BAND
    crop = (slice(y0, y0 + ps), slice(x0, x0 + ps))
    h, v, i, d = (s[:, crop[0], crop[1]] for s in (h, v, i, d))
    g, m = g[crop], m[crop]
    if mpi is not None:
        mpi = mpi[:, crop[0], crop[1]]
    for _ in range(int(aug.rot_k[b])):
        h, v, i, d = _rot(h), _rot(v), _rot(i), _rot(d)
        h, v = v, torch.flip(h, (0,))
        i, d = d, torch.flip(i, (0,))
        g = _rot(g[..., None])[..., 0]
        if mpi is not None:
            mpi = _rot(mpi)
    color = torch.as_tensor(np.asarray(aug.color[b]), device=h.device)
    h, v, i, d = (s @ color.T * float(aug.brightness[b])
                  for s in (h, v, i, d))
    c = float(aug.contrast[b])
    pivot = torch.mean(h) * (1.0 - c)
    h, v, i, d = (s * c + pivot for s in (h, v, i, d))
    return [fold(s) for s in (h, v, i, d)], g, mpi, m


def microbatch(scenes, batch, lo: int, hi: int, ps: int, win: int):
    """Samples ``[lo, hi)``: stacked model inputs, gt, the MPI ``(b, K,
    ps, ps, 5)`` (or None) and the loss mask (the augmented mask times
    the train margin)."""
    rows = [sample_inputs(scenes, batch, b, ps, win) for b in range(lo, hi)]
    stacks = [torch.stack([r[0][k] for r in rows]) for k in range(4)]
    gt = torch.stack([r[1] for r in rows])
    mpi = None if rows[0][2] is None else torch.stack([r[2] for r in rows])
    mask = torch.stack([r[3] for r in rows]).float()
    margin = torch.zeros_like(mask[0])
    margin[LOSS_MARGIN:ps - LOSS_MARGIN, LOSS_MARGIN:ps - LOSS_MARGIN] = 1.0
    return stacks, gt, mpi, mask * margin


def lr_at(lr: float, step: int, warm_start: bool) -> float:
    """The recipe's learning rate: ``lr·step/1000`` up to step 1000 under
    the warm start, in float32."""
    if warm_start and step <= 1000:
        return float(np.float32(lr) * np.float32(step) / np.float32(1000.0))
    return float(np.float32(lr))


def train_reference(net, model: dict, recipe: dict, sd: dict, scenes,
                    batches, device, prec: str = 'fp32', fault: str = ''):
    """Follow the program's first ``len(batches)`` train steps of ``net``
    (a module of ``nets/``) from the initial state dict ``sd`` on the same
    drawn batches.

    Each step splits the batch into ``train_accum`` microbatches, averages
    their losses and gradients, keeps the BatchNorm running statistics of
    microbatch 0, and takes an Adam step (β 0.9 / 0.999, ε 1e-8, bias
    corrected) at the scheduled rate.  ``fault='half'`` leaves the second
    half of every microbatch out.  Returns ``{'losses', 'grads' (the
    first step's, by leaf), 'params', 'buffers' (after the last step)}``.
    """
    no_tf32()
    params, buffers = split_state(sd, device)
    m = {k: torch.zeros_like(p) for k, p in params.items()}
    v = {k: torch.zeros_like(p) for k, p in params.items()}
    accum, ps = int(recipe['train_accum']), int(recipe['train_ps'])
    win = window_size(ps)
    losses, first_grads = [], None
    for step, batch in enumerate(batches):
        n = len(batch.scene)
        size = n // accum
        grads = {k: torch.zeros_like(p) for k, p in params.items()}
        total = 0.0
        for c in range(accum):
            hi = c * size + (size // 2 if fault == 'half' else size)
            stacks, gt, mpi, mask = microbatch(scenes, batch, c * size, hi,
                                               ps, win)
            out = net.forward(model, params, buffers, stacks, train=True,
                              update=c == 0, prec=prec)
            loss = net.loss(out, gt, mpi, mask) / accum
            for k, g in zip(params, torch.autograd.grad(
                    loss, list(params.values()))):
                grads[k] += g
            total += float(loss.detach())
            del stacks, mpi, out, loss
        losses.append(total)
        if first_grads is None:
            first_grads = {k: g.clone() for k, g in grads.items()}
        t = step + 1
        lr = lr_at(recipe['train_lr'], step, recipe['train_warm_start'])
        with torch.no_grad():
            for k, p in params.items():
                g = grads[k]
                m[k].mul_(ADAM['b1']).add_((1.0 - ADAM['b1']) * g)
                v[k].mul_(ADAM['b2']).add_((1.0 - ADAM['b2']) * g * g)
                mh = m[k] / (1.0 - ADAM['b1'] ** t)
                vh = v[k] / (1.0 - ADAM['b2'] ** t)
                p.sub_(lr * mh / (torch.sqrt(vh) + ADAM['eps']))
    return {'losses': losses, 'grads': first_grads,
            'params': {k: p.detach() for k, p in params.items()},
            'buffers': buffers}


def window_size(ps: int) -> int:
    """The drawn window's side: patch, the crop band and the wrap guards,
    rounded up to 16."""
    return (ps + 16 + 2 * 8 + 15) // 16 * 16


# -------------------------------------------------------------- validation

def ensemble_grid(disp_min: float, disp_max: float, step: float):
    """The member shifts, ``arange(min, max, step)`` in float32."""
    return np.arange(disp_min, disp_max, step, dtype=np.float32)


def bin_grid(lo: float, hi: float, n: int, device) -> torch.Tensor:
    return torch.from_numpy(np.linspace(lo, hi, n).astype(np.float32)).to(
        device)


@torch.no_grad()
def ese_members(net, model: dict, sd: dict, stacks, grid, device,
                prec: str = 'fp32', fault: str = ''):
    """Every member's mean (shift added back) and logvar of one scene's
    ``(n, H, W, 3)`` stacks: the eval forward of ``net`` (running
    statistics) of the stacks EPI-shifted by the member's disparity.
    ``(K, H, W)`` each.  ``fault='member'`` adds 0.5 to the last member's
    mean."""
    no_tf32()
    params, buffers = split_state(sd, device)
    means, logvars = [], []
    for s in grid:
        shifted = shift_stacks(*stacks, float(s))
        out = net.forward(model, params, buffers,
                          [fold(x)[None] for x in shifted], train=False,
                          prec=prec)
        means.append(out['mean'][0] + float(s))
        logvars.append(out['logvar'][0])
    means, logvars = torch.stack(means), torch.stack(logvars)
    if fault == 'member':
        means[-1] += 0.5
    return means, logvars


@torch.no_grad()
def mixture_posterior(means, logvars, lo: float, hi: float, n_bins: int):
    """``(H, W, n_bins)``: the mean over members of the Laplace density
    with scale ``exp(logvar)`` on ``linspace(lo, hi, n_bins)``."""
    bins = bin_grid(lo, hi, n_bins, means.device)
    out = torch.zeros(means.shape[1:] + (n_bins,), dtype=torch.float64,
                      device=means.device)
    for m, lv in zip(means.double(), logvars.double()):
        sc = torch.exp(lv)[..., None]
        out += torch.exp(-torch.abs(bins.double() - m[..., None]) / sc) / \
            (2.0 * sc)
    return (out / means.shape[0]).float()


def _laplace_bins(n_bins, lo, hi, mean, scale):
    """Probability of each of ``n_bins`` equal bins around
    ``linspace(lo, hi, n_bins)`` under a Laplace law."""
    step = (hi - lo) / n_bins
    edges = torch.from_numpy(np.linspace(lo - step / 2.0, hi + step / 2.0,
                                         n_bins + 1).astype(np.float32)).to(
        mean.device).double()
    mean, scale = mean.double()[..., None], scale.double()[..., None]
    cdf = torch.where(edges < mean, torch.exp((edges - mean) / scale) / 2.0,
                      1.0 - torch.exp(-(edges - mean) / scale) / 2.0)
    return cdf[..., 1:] - cdf[..., :-1]


@torch.no_grad()
def scene_metrics(mean, logvar, gt, mpi, lo, hi, margin: int = 15,
                  n_bins: int = 108):
    """The validation report of one scene: MSE and BadPix(0.07) of the
    selected mean over the margin mask, and the KL divergences of the
    MPI's alpha-weighted bin histogram from the 108-bin law of the
    selected member (all, multimodal and unimodal pixels).  The reference
    code keys the report's law off the checkpoint's stored config, a UPR
    training run's: the Laplace law of the selected mean with scale
    ``exp(logvar)``."""
    h, w = gt.shape
    mask = torch.zeros((h, w), dtype=torch.float64, device=gt.device)
    mask[margin:h - margin, margin:w - margin] = 1.0
    err = (mean.double() - gt.double())
    mse = float((err ** 2 * mask).sum() / mask.sum())
    bad = float(((err.abs() > 0.07).double() * mask).sum() / mask.sum())
    dist = _laplace_bins(n_bins, lo, hi, mean, torch.exp(logvar))

    # the GT histogram: each MPI plane's alpha in the bin whose float32
    # centre lies within half a step of its disparity (whole layers share
    # one disparity, so the bin test is made in float32, as the grid is)
    step = (hi - lo) / n_bins
    centers = bin_grid(lo, hi, n_bins, gt.device)
    dist_gt = torch.zeros_like(dist)
    for plane in mpi.float():
        hot = (torch.abs(centers - plane[..., 4, None]) < step / 2.0)
        dist_gt += hot.double() * plane[..., 3, None].double()
    p = dist + 1e-5
    p = p / p.sum(-1, keepdim=True)
    g = dist_gt + 1e-5
    g = g / g.sum(-1, keepdim=True)
    kld = (g * torch.log(g / p)).sum(-1)
    mm = ((mpi[..., 3] > 0.3).sum(0) > 1).double()
    return {'mse': mse, 'bad_pix': bad, 'kld': float(kld.mean()),
            'kld_mm': float((kld * mm).sum() / mm.sum()),
            'kld_um': float((kld * (1 - mm)).sum() / (1 - mm).sum())}
