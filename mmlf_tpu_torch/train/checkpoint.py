"""The rolling ``checkpoint.pt`` of a training run.

One checkpoint per output directory, written at every validation interval,
on SIGTERM and on completion, in the reference format
(``utils/convert.save_checkpoint_pt``): ``model_state_dict``, the torch
Adam ``optimizer_state_dict``, the full ``hyper_parameters`` dict,
``epoch``, ``iteration`` and ``loss``.  The write is atomic (temporary file
+ rename), so a reader — the validate CLI, a resumed run — never sees half
a file.  The train loop writes through ``ModelSaver``: the snapshot on the
training thread, the write on a background thread.

``load_checkpoint_raw`` reads the JAX package's run directory instead:
``checkpoint.msgpack`` (flax.serialization of the train state, decoded by
``utils/msgpack.py``) and ``hyper_parameters.json``.
"""

from __future__ import annotations

import json
import os
import threading
from typing import Optional

from ..utils import msgpack
from ..utils.convert import (checkpoint_payload, read_checkpoint_pt,
                             write_checkpoint_pt)

CKPT_PT = 'checkpoint.pt'
CKPT_MSGPACK = 'checkpoint.msgpack'
HYPER_FILE = 'hyper_parameters.json'


def checkpoint_path(out_dir: str) -> str:
    return os.path.join(out_dir, CKPT_PT)


def has_checkpoint(out_dir: str) -> bool:
    return os.path.exists(checkpoint_path(out_dir))


def _build_payload(model, optimizer, cfg, epoch: Optional[int],
                   iteration: int, loss: Optional[float]) -> dict:
    """Host snapshot of the checkpoint payload (the blocking part): every
    tensor of the model's and the optimizer's state dicts is copied, since
    those hold the live tensors that the next step updates in place."""
    return checkpoint_payload(
        model.state_dict(), cfg, epoch=epoch, iteration=iteration,
        loss=float('nan') if loss is None else float(loss),
        optimizer_state_dict=optimizer.state_dict())


def _write_checkpoint(out_dir: str, payload: dict) -> None:
    write_checkpoint_pt(checkpoint_path(out_dir), payload)


def save_checkpoint(out_dir: str, model, optimizer, cfg, epoch: int,
                    iteration: int, loss: float) -> None:
    _write_checkpoint(out_dir, _build_payload(model, optimizer, cfg, epoch,
                                              iteration, loss))


class ModelSaver:
    """Rolling saver with optional best-only mode (reference dl.py:7-74).

    With ``async_write=True`` (default) the serialization and the disk
    write run on one daemon thread, so the train loop blocks only for the
    snapshot; a newer pending save replaces an unwritten older one (the
    checkpoint is rolling anyway).  A failed write is raised as
    ``RuntimeError('async checkpoint write failed')`` at the next save or
    at ``close()``, which drains the writer.
    """

    def __init__(self, only_best: bool = False, async_write: bool = True):
        self.only_best = only_best
        self.best_loss = None
        self.async_write = async_write
        self._pending = None
        self._error = None
        self._closed = False
        self._lock = threading.Condition()
        self._thread = None
        if async_write:
            self._thread = threading.Thread(target=self._worker,
                                            daemon=True)
            self._thread.start()

    def _worker(self):
        while True:
            with self._lock:
                while self._pending is None and not self._closed:
                    self._lock.wait()
                if self._pending is None:
                    return
                job, self._pending = self._pending, None
            try:
                _write_checkpoint(*job)
            except BaseException as e:       # noqa: BLE001
                # the writer stays alive (a later save may succeed, e.g.
                # once disk space is freed); the training thread raises it
                # at its next save or close
                with self._lock:
                    self._error = e

    def __call__(self, out_dir: str, model, optimizer, cfg,
                 epoch: Optional[int], iteration: int,
                 loss: Optional[float]) -> bool:
        """Save (or, in best-only mode, skip a worse loss); returns whether
        a save was made."""
        if self.only_best and loss is not None:
            if self.best_loss is not None and self.best_loss < loss:
                return False
            self.best_loss = loss
        payload = _build_payload(model, optimizer, cfg, epoch, iteration,
                                 loss)
        if not self.async_write:
            _write_checkpoint(out_dir, payload)
            return True
        with self._lock:
            self._raise_pending_error()
            self._pending = (out_dir, payload)
            self._lock.notify()
        return True

    def _raise_pending_error(self):
        if self._error is not None:
            e, self._error = self._error, None
            raise RuntimeError('async checkpoint write failed') from e

    def close(self):
        """Drain the writer (call at the end of training)."""
        if self._thread is None:
            return
        with self._lock:
            self._closed = True
            self._lock.notify()
        self._thread.join()
        with self._lock:
            self._raise_pending_error()


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
