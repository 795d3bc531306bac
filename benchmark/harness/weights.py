"""The seeded weights every cell hands to the port and to the reference,
as a state dict of the UPR network's reference keys.

Conv kernels are lecun-normal (variance 1 / fan-in), drawn on the device by
one ``torch.Generator`` seeded from the run's seed in one call and cut per
leaf; biases, BatchNorm's β and running mean are 0, γ and the running
variance 1: the start of a training run.  ``calibrate_bn`` gives an eval
checkpoint live statistics.
"""

from __future__ import annotations

import torch


def _blocks(chs: int, views: int, in_blocks: int, out_blocks: int):
    """``(prefix, cin, cout, with_bn)`` of every conv block."""
    out = []
    for net in ('in_net_hv', 'in_net_id'):
        for b in range(in_blocks):
            out.append((f'{net}.{b}', 3 * views if b == 0 else chs, chs,
                        True))
    cat = 4 * chs
    for b in range(out_blocks - 1):
        out.append((f'out_net.{b}', cat, cat, True))
    out.append((f'out_net.{out_blocks - 1}', cat, 2, False))
    return out


def conv_shapes(model: dict) -> dict:
    """``{key: shape}`` of every conv weight, in draw order."""
    shapes = {}
    for prefix, cin, cout, _ in _blocks(**_widths(model)):
        shapes[f'{prefix}.0.weight'] = (cout, cin, 2, 2)
        shapes[f'{prefix}.2.weight'] = (cout, cout, 2, 2)
    return shapes


def _widths(model: dict) -> dict:
    return dict(chs=model['model_chs'], views=model['model_views'],
                in_blocks=model['model_in_blocks'],
                out_blocks=model['model_out_blocks'])


def make_state_dict(model: dict, seed: int, device) -> dict:
    """The network's initial state dict on ``device`` from ``seed``."""
    if model.get('model_ksize', 2) != 2:
        raise ValueError('the benchmark draws k=2 nets only')
    gen = torch.Generator(device=device).manual_seed(int(seed))
    shapes = conv_shapes(model)
    total = sum(torch.Size(s).numel() for s in shapes.values())
    draw = torch.randn(total, generator=gen, device=device)
    sd, at = {}, 0
    for key, shape in shapes.items():
        n = torch.Size(shape).numel()
        fan_in = shape[1] * shape[2] * shape[3]
        sd[key] = (draw[at:at + n] * fan_in ** -0.5).reshape(shape)
        at += n
    for prefix, _, cout, with_bn in _blocks(**_widths(model)):
        for conv in ('0', '2'):
            sd[f'{prefix}.{conv}.bias'] = torch.zeros(cout, device=device)
        if with_bn:
            sd[f'{prefix}.3.weight'] = torch.ones(cout, device=device)
            sd[f'{prefix}.3.bias'] = torch.zeros(cout, device=device)
            sd[f'{prefix}.3.running_mean'] = torch.zeros(cout, device=device)
            sd[f'{prefix}.3.running_var'] = torch.ones(cout, device=device)
            sd[f'{prefix}.3.num_batches_tracked'] = torch.zeros(
                (), dtype=torch.int64, device=device)
    return sd
