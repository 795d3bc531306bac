"""Carry weights between the JAX package, reference checkpoints and the port.

The port's ``FeedForward`` uses the reference state-dict keys, so a
reference ``checkpoint.pt`` loads as it is.  ``state_dict_from_jax`` maps
the JAX package's variable tree onto the same keys:

  ``params/in_net_hv/block<b>/conv1``   → ``in_net_hv.<b>.0`` (Conv)
  ``params/in_net_hv/block<b>/conv2``   → ``in_net_hv.<b>.2`` (Conv)
  ``params/in_net_hv/block<b>/bn`` +
  ``batch_stats/in_net_hv/block<b>/bn`` → ``in_net_hv.<b>.3`` (BatchNorm)
  ``in_net_id``, ``out_net``            → likewise

for an INN (``--model_inn``, ``models/inn.py``; flax names the blocks of
a list ``<net>_<b>``):

  ``params/<net>_<b>/{act_scale,act_offset,perm}`` → ``<net>.<b>.…``
  ``params/<net>_<b>/s{1,2}/conv{1,2}``  → ``<net>.<b>.s{1,2}.conv{1,2}``
  ``params/<net>_<b>/s{1,2}/bn`` +
  ``batch_stats/…``                      → ``<net>.<b>.s{1,2}.bn``
  ``params/mu``                          → ``mu``

and, for a ``--model_unet`` net, the U-Net out_net (``models/unet.py``;
``out_net.`` before each key on the right):

  ``params/out_net/down<i>/conv{0,1}``  → ``down_path.<i>.block.{0,3}``
  ``params/out_net/down<i>/bn{0,1}`` +
  ``batch_stats/…``                     → ``down_path.<i>.block.{2,5}``
  ``params/out_net/up<i>/up``           → ``up_path.<j>.up``
  ``params/out_net/up<i>/conv_block/…`` → ``up_path.<j>.conv_block.…``
  ``params/out_net/last``               → ``last``

with ``j = depth - 2 - i``.  Conv kernels transpose HWIO → OIHW; a
transposed conv's kernel (flax ``ConvTranspose``, HWIO) also flips its
taps, because flax correlates the dilated input with the kernel where
torch scatters with it, and transposes to torch's ``(in, out, kH, kW)``.
Input-channel order is the same (view-major, colour-minor) in both
packages.  The leaves may be numpy or JAX arrays: a JAX train state's
``params`` and ``batch_stats`` convert as they are, and so does a gradient
tree shaped like ``params`` (pass it as ``params`` with the state's
``batch_stats``).
"""

from __future__ import annotations

import os
from typing import Dict

import numpy as np
import torch


def _tensor(x) -> torch.Tensor:
    return torch.from_numpy(np.array(x, dtype=np.float32, copy=True))


def _conv(conv: dict) -> tuple:
    """flax HWIO conv → OIHW weight and bias."""
    return (_tensor(np.transpose(np.asarray(conv['kernel']), (3, 2, 0, 1))),
            _tensor(conv['bias']))


def _conv_transpose(conv: dict) -> tuple:
    """flax ``ConvTranspose`` HWIO → torch ``ConvTranspose2d`` ``(in, out,
    kH, kW)``: the taps flipped, then transposed."""
    k = np.asarray(conv['kernel'])[::-1, ::-1]
    return _tensor(np.transpose(k, (2, 3, 0, 1))), _tensor(conv['bias'])


def _unet_state(params: dict, stats: dict, sd: dict,
                prefix: str = 'out_net.',
                depth: int = 5) -> None:
    """The JAX U-Net's variables into ``sd`` under the reference's keys."""
    def block(p: dict, s: dict, pfx: str) -> None:
        for conv, bn, ci, bi in (('conv0', 'bn0', 0, 2),
                                 ('conv1', 'bn1', 3, 5)):
            sd[f'{pfx}.{ci}.weight'], sd[f'{pfx}.{ci}.bias'] = _conv(p[conv])
            sd[f'{pfx}.{bi}.weight'] = _tensor(p[bn]['scale'])
            sd[f'{pfx}.{bi}.bias'] = _tensor(p[bn]['bias'])
            sd[f'{pfx}.{bi}.running_mean'] = _tensor(s[bn]['mean'])
            sd[f'{pfx}.{bi}.running_var'] = _tensor(s[bn]['var'])
            sd[f'{pfx}.{bi}.num_batches_tracked'] = torch.tensor(
                0, dtype=torch.int64)

    for i in range(depth):
        block(params[f'down{i}'], stats[f'down{i}'],
              f'{prefix}down_path.{i}.block')
    for j in range(depth - 1):
        i = depth - 2 - j
        up = params[f'up{i}']
        sd[f'{prefix}up_path.{j}.up.weight'], \
            sd[f'{prefix}up_path.{j}.up.bias'] = _conv_transpose(up['up'])
        block(up['conv_block'], stats[f'up{i}']['conv_block'],
              f'{prefix}up_path.{j}.conv_block.block')
    sd[f'{prefix}last.weight'], sd[f'{prefix}last.bias'] = _conv(
        params['last'])


def coupling_block_state(p: dict, st, prefix: str = '') -> dict:
    """One JAX ``AIOCouplingBlock``'s params ``p`` and batch stats ``st``
    (None for a gradient tree) under the port's keys, each after
    ``prefix``."""
    sd: Dict[str, torch.Tensor] = {}
    for leaf in ('act_scale', 'act_offset', 'perm'):
        sd[f'{prefix}{leaf}'] = _tensor(p[leaf])
    for sub in ('s1', 's2'):
        for conv in ('conv1', 'conv2'):
            sd[f'{prefix}{sub}.{conv}.weight'], \
                sd[f'{prefix}{sub}.{conv}.bias'] = _conv(p[sub][conv])
        bn = f'{prefix}{sub}.bn'
        sd[f'{bn}.weight'] = _tensor(p[sub]['bn']['scale'])
        sd[f'{bn}.bias'] = _tensor(p[sub]['bn']['bias'])
        if st is not None:
            sd[f'{bn}.running_mean'] = _tensor(st[sub]['bn']['mean'])
            sd[f'{bn}.running_var'] = _tensor(st[sub]['bn']['var'])
        sd[f'{bn}.num_batches_tracked'] = torch.tensor(0, dtype=torch.int64)
    return sd


def _inn_state(variables: dict, cfg: dict) -> Dict[str, torch.Tensor]:
    """The JAX INN's variables under the port's ``models/inn.py`` keys."""
    params = variables['params']
    stats = variables.get('batch_stats', {})
    sd: Dict[str, torch.Tensor] = {}
    nets = [('in_net_hv', cfg['model_in_blocks'])]
    if not cfg.get('model_cross', False):
        nets.append(('in_net_id', cfg['model_in_blocks']))
    nets.append(('out_net', cfg['model_out_blocks']))
    for name, n_blocks in nets:
        for b in range(n_blocks):
            sd.update(coupling_block_state(params[f'{name}_{b}'],
                                           stats.get(f'{name}_{b}'),
                                           f'{name}.{b}.'))
    sd['mu'] = _tensor(params['mu'])
    return sd


def state_dict_from_jax(variables: dict, cfg) -> Dict[str, torch.Tensor]:
    """``{'params', 'batch_stats'}`` of ``mmlf_tpu.models.FeedForward``
    (numpy leaves) → the port's state dict.

    :param cfg: a ``Config`` (or its dict) with the block counts,
        ``model_cross`` and ``model_unet``
    """
    cfg = cfg if isinstance(cfg, dict) else cfg.to_dict()
    if cfg.get('model_inn'):
        return _inn_state(variables, cfg)
    params = variables['params']
    stats = variables.get('batch_stats', {})
    sd: Dict[str, torch.Tensor] = {}

    def export_net(name: str, n_blocks: int):
        for b in range(n_blocks):
            blk = params[name][f'block{b}']
            for conv, idx in (('conv1', 0), ('conv2', 2)):
                sd[f'{name}.{b}.{idx}.weight'], \
                    sd[f'{name}.{b}.{idx}.bias'] = _conv(blk[conv])
            if 'bn' in blk:
                bn_s = stats[name][f'block{b}']['bn']
                sd[f'{name}.{b}.3.weight'] = _tensor(blk['bn']['scale'])
                sd[f'{name}.{b}.3.bias'] = _tensor(blk['bn']['bias'])
                sd[f'{name}.{b}.3.running_mean'] = _tensor(bn_s['mean'])
                sd[f'{name}.{b}.3.running_var'] = _tensor(bn_s['var'])
                sd[f'{name}.{b}.3.num_batches_tracked'] = torch.tensor(
                    0, dtype=torch.int64)

    export_net('in_net_hv', cfg['model_in_blocks'])
    if not cfg.get('model_cross', False):
        export_net('in_net_id', cfg['model_in_blocks'])
    if cfg.get('model_unet'):
        _unet_state(params['out_net'], stats['out_net'], sd)
    else:
        export_net('out_net', cfg['model_out_blocks'])
    return sd


def _to_cpu(obj):
    """Tensors of a nested dict/list/tuple copied to the CPU.  Always a
    copy, also of a CPU tensor: the result is a snapshot that later
    in-place updates of the live tensors (the next optimizer step) do not
    reach."""
    if torch.is_tensor(obj):
        return obj.detach().to('cpu', copy=True)
    if isinstance(obj, dict):
        return {k: _to_cpu(v) for k, v in obj.items()}
    if isinstance(obj, (list, tuple)):
        return type(obj)(_to_cpu(v) for v in obj)
    return obj


def checkpoint_payload(state_dict: dict, cfg, epoch=None, iteration: int = 0,
                       loss: float = 0.0, optimizer_state_dict=None) -> dict:
    """The contents of a reference-format ``checkpoint.pt``: model state,
    optimizer state (torch Adam's ``state_dict()``, or None), the full
    hyper-parameter dict, epoch, iteration and loss, every tensor copied
    to the CPU."""
    cfg_dict = cfg if isinstance(cfg, dict) else cfg.to_dict()
    return {'model_state_dict': _to_cpu(dict(state_dict)),
            'optimizer_state_dict': _to_cpu(optimizer_state_dict),
            'hyper_parameters': cfg_dict, 'epoch': epoch,
            'iteration': iteration, 'loss': loss}


def write_checkpoint_pt(path: str, payload: dict) -> None:
    """Write ``payload`` to ``path`` atomically (temporary file + rename):
    a reader never sees half a file."""
    tmp = f'{path}.tmp'
    torch.save(payload, tmp)
    os.replace(tmp, path)


def save_checkpoint_pt(path: str, state_dict: dict, cfg, epoch=None,
                       iteration: int = 0, loss: float = 0.0,
                       optimizer_state_dict=None) -> None:
    """Write a reference-format ``checkpoint.pt`` (``checkpoint_payload``),
    atomically."""
    write_checkpoint_pt(path, checkpoint_payload(
        state_dict, cfg, epoch=epoch, iteration=iteration, loss=loss,
        optimizer_state_dict=optimizer_state_dict))


def read_checkpoint_pt(path: str) -> dict:
    """The whole payload of a reference-format ``checkpoint.pt``.  It holds
    tensors and plain Python values only, so it is read with
    ``weights_only=True``: unpickling runs no code from the file."""
    return torch.load(path, map_location='cpu', weights_only=True)


def load_checkpoint_pt(path: str) -> tuple:
    """Load a reference-format ``checkpoint.pt``.

    Returns ``(state_dict, hyper_parameters)``: the model state dict with
    temporary ``*tmp*`` keys stripped, and the stored config dict.
    """
    state = read_checkpoint_pt(path)
    sd = {k: v for k, v in state['model_state_dict'].items()
          if 'tmp' not in k}
    return sd, dict(state['hyper_parameters'])
