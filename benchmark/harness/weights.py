"""The seeded weights every cell hands to the port and to the reference,
as a state dict of the program's keys, whose leaves the configuration's
net lists (``nets.py``).

Conv kernels are lecun-normal (variance 1 / fan-in), drawn on the device by
one ``torch.Generator`` seeded from the run's seed in one call and cut per
leaf; biases, BatchNorm's β and running mean are 0, γ and the running
variance 1: the start of a training run.  ``calibrate_bn`` gives an eval
checkpoint live statistics.
"""

from __future__ import annotations

import math

import torch


def conv_block_leaves(blocks):
    """``(drawn, fixed)`` of ``reference.conv_blocks``' blocks: each
    block's two conv kernels (``.0``, ``.2``) drawn, block after block;
    their biases, and the BatchNorm (``.3``) of a block that has one,
    fixed."""
    drawn, fixed = {}, {}
    for prefix, cin, cout, _ in blocks:
        drawn[f'{prefix}.0.weight'] = (cout, cin, 2, 2)
        drawn[f'{prefix}.2.weight'] = (cout, cout, 2, 2)
    for prefix, _, cout, with_bn in blocks:
        for conv in ('0', '2'):
            fixed[f'{prefix}.{conv}.bias'] = ((cout,), 0.0)
        if with_bn:
            for leaf, fill in (('weight', 1.0), ('bias', 0.0),
                               ('running_mean', 0.0), ('running_var', 1.0),
                               ('num_batches_tracked', 0)):
                fixed[f'{prefix}.3.{leaf}'] = (
                    () if leaf == 'num_batches_tracked' else (cout,), fill)
    return drawn, fixed


def make_state_dict(net, model: dict, seed: int, device) -> dict:
    """The initial state dict of ``net`` (a module of ``nets/``) at the
    widths of ``model`` on ``device`` from ``seed``."""
    drawn, fixed = net.leaves(model)
    gen = torch.Generator(device=device).manual_seed(int(seed))
    total = sum(torch.Size(s).numel() for s in drawn.values())
    draw = torch.randn(total, generator=gen, device=device)
    sd, at = {}, 0
    for key, shape in drawn.items():
        n = torch.Size(shape).numel()
        fan_in = math.prod(shape[1:])
        sd[key] = (draw[at:at + n] * fan_in ** -0.5).reshape(shape)
        at += n
    for key, (shape, fill) in fixed.items():
        sd[key] = torch.full(shape, fill, device=device,
                             dtype=torch.int64 if isinstance(fill, int)
                             else torch.float32)
    return sd
