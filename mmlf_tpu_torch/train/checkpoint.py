"""The rolling ``checkpoint.pt`` of a training run.

One checkpoint per output directory, written at every validation interval,
on SIGTERM and on completion, in the reference format
(``utils/convert.save_checkpoint_pt``): ``model_state_dict``, the torch
Adam ``optimizer_state_dict``, the full ``hyper_parameters`` dict,
``epoch``, ``iteration`` and ``loss``.  The write is atomic (temporary file
+ rename), so a reader — the validate CLI, a resumed run — never sees half
a file.

``load_checkpoint_raw`` reads the JAX package's run directory instead:
``checkpoint.msgpack`` (flax.serialization of the train state, decoded by
``utils/msgpack.py``) and ``hyper_parameters.json``.
"""

from __future__ import annotations

import json
import os

from ..utils import msgpack
from ..utils.convert import read_checkpoint_pt, save_checkpoint_pt

CKPT_PT = 'checkpoint.pt'
CKPT_MSGPACK = 'checkpoint.msgpack'
HYPER_FILE = 'hyper_parameters.json'


def checkpoint_path(out_dir: str) -> str:
    return os.path.join(out_dir, CKPT_PT)


def has_checkpoint(out_dir: str) -> bool:
    return os.path.exists(checkpoint_path(out_dir))


def save_checkpoint(out_dir: str, model, optimizer, cfg, epoch: int,
                    iteration: int, loss: float) -> None:
    save_checkpoint_pt(checkpoint_path(out_dir), model.state_dict(), cfg,
                       epoch=epoch, iteration=iteration, loss=float(loss),
                       optimizer_state_dict=optimizer.state_dict())


def load_checkpoint(out_dir: str) -> dict:
    """The stored payload (tensors on the CPU)."""
    return read_checkpoint_pt(checkpoint_path(out_dir))


def load_checkpoint_raw(out_dir: str):
    """The JAX package's checkpoint: ``(tree, meta, hyper)``.

    ``tree`` is the decoded train state (``params``, ``batch_stats`` and
    the optimizer state, which the port does not use), ``meta`` its
    ``__meta__`` record (epoch, iteration, loss), ``hyper`` the stored
    config dict.
    """
    with open(os.path.join(out_dir, CKPT_MSGPACK), 'rb') as f:
        tree = msgpack.unpackb(f.read())
    meta = tree.pop('__meta__')
    with open(os.path.join(out_dir, HYPER_FILE)) as f:
        hyper = json.load(f)
    return tree, meta, hyper
