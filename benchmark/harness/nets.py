"""A configuration's net: the module ``nets/<name>.py`` of the benchmark,
named by the configuration file's ``"net"`` (``"upr"`` where it names
none) and loaded by path, as ``run.resolve`` loads the metric readers.

A net module is plain PyTorch: it imports nothing of the program and no
JAX, and may use ``reference.py``'s ``Net`` (the four streams, and the
out_net of conv blocks after them) and ``conv_blocks``, and
``weights.py``'s ``conv_block_leaves``.  It provides:

* ``leaves(model) -> (drawn, fixed)``: ``drawn`` ``{key: shape}`` of the
  lecun-normal conv kernels in draw order, ``fixed`` ``{key: (shape,
  fill)}`` of the leaves that start at a constant (a float fill is a
  float32 leaf, an int one an int64 count), with the BatchNorm leaves;
  the keys are the program's state dict's;
* ``forward(model, params, buffers, stacks, train, update=False,
  prec='fp32', momentum=reference.BN_MOMENTUM) -> {name: tensor}``: the
  reference forward of the whole net from the four folded stacks;
* ``loss(out, gt, mpi, mask)``: the train loss of ``forward``'s outputs,
  averaged over the mask;
* ``USES_MPI``: whether ``loss`` reads the MPI ``(b, K, ps, ps, 5)``
  (else it gets None);
* ``flop_per_pixel(model)``: forward FLOP per output pixel (``step_mfu``,
  ``scene_mfu``);
* ``k3_blocks(model)``: ``[((cin, cout), count)]`` of the k=2 conv blocks
  of one forward that K3 runs (``k3_roofline``);
* ``ESE``: whether the shift ensemble applies: ``forward`` gives ``mean``
  and ``logvar``.

``model`` is the configuration's ``port_config``.
"""

from __future__ import annotations

import importlib.util
import os
import re

NETS_DIR = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), 'nets')
DEFAULT = 'upr'
NAME = re.compile(r'[A-Za-z0-9_][A-Za-z0-9_-]{0,63}')


def load(config: dict):
    """The module of ``config``'s net, from ``NETS_DIR``."""
    name = config.get('net', DEFAULT)
    if not NAME.fullmatch(name):
        raise ValueError(f'net {name!r}: not a name of a module under '
                         f'{NETS_DIR}')
    path = os.path.join(NETS_DIR, f'{name}.py')
    spec = importlib.util.spec_from_file_location(f'bench_net_{name}', path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod
