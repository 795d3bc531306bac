"""Data-parallel ranks: the process group, the rank's slice of a global
batch, and collectives that keep global-batch semantics under autograd.

The counterpart of ``mmlf_tpu/parallel/mesh.py`` for ``--mesh_data``,
and (``member_share``, ``row_share``, ``gather_dim``) for the validate
CLI's ``--mesh_ensemble`` and ``--mesh_space``.  The
JAX package shards the global batch over a ``data`` mesh and lets XLA keep
its semantics: the loss is the global batch's, BatchNorm statistics are
global (a batch-axis mean under ``jit``), and gradients come out summed
over the devices.  Here every rank is a process (``launch`` starts them),
holds a replica of the model and of the scene cache, and draws the same
global batch from the same seed; ``shard_batch`` gives it its samples.  The
pieces that make the ranks compute the single-device step:

  * ``all_reduce_sum``: a sum over ranks whose backward sums the cotangent
    over ranks (BatchNorm's Σx, Σx² and K3's per-channel sums, as
    SyncBatchNorm and the JAX kernel's ``psum`` do);
  * ``all_gather``: the model outputs and targets of every rank, so each
    rank computes the global batch's loss itself; its backward hands each
    rank the cotangent of its own samples (the loss is computed once per
    rank, not summed over ranks);
  * ``sum_gradients``: each rank's parameter gradients are its samples'
    part of the global gradient, summed once after the backward.

Stock DDP would average per-rank gradients of per-rank losses and keep
per-rank BatchNorm statistics, neither of which is the JAX step.

Backends: NCCL with one rank a GPU, or gloo (the CPU, or several ranks
sharing one GPU); gloo's collectives run on host copies of CUDA tensors.
"""

from __future__ import annotations

import os
import queue
import shutil
import signal
import tempfile
import threading
import time
import traceback
from datetime import timedelta

import numpy as np
import torch
import torch.distributed as dist

# how long the ranks of a run may wait for one another in a collective
COLLECTIVE_TIMEOUT_S = 1800


def world() -> int:
    """Number of ranks of this process's group (1 outside a group)."""
    return dist.get_world_size() if dist.is_available() and \
        dist.is_initialized() else 1


def rank() -> int:
    """This process's rank (0 outside a group)."""
    return dist.get_rank() if world() > 1 else 0


def rank_device(device_type: str, r: int) -> torch.device:
    """The device of rank ``r``: the CPU, or GPU ``r`` modulo the visible
    GPUs (several gloo ranks may share one)."""
    if device_type == 'cpu':
        return torch.device('cpu')
    return torch.device('cuda', r % torch.cuda.device_count())


def shard_indices(n: int, accum: int, r: int, n_ranks: int) -> np.ndarray:
    """Rank ``r``'s samples of a global batch of ``n`` taken as ``accum``
    microbatches: within each microbatch its contiguous ``1/n_ranks``, as
    the JAX package's ``data``-sharded batch splits a microbatch over the
    devices.  The rank's own microbatch c is then ``[c·m, (c+1)·m)`` of the
    result, ``m = n / (accum·n_ranks)``."""
    size = n // accum
    if n % accum or size % n_ranks:
        raise ValueError(f'a batch of {n} in {accum} microbatch(es) does not '
                         f'split over {n_ranks} ranks')
    piece = size // n_ranks
    return np.concatenate([np.arange(c * size + r * piece,
                                     c * size + (r + 1) * piece)
                           for c in range(accum)])


def shard_batch(batch, r: int, n_ranks: int, accum: int = 1):
    """Rank ``r``'s part (``shard_indices``) of a host ``Batch`` or a
    ``DeviceBatch`` (numpy fields, the augmentation parameters included)."""
    idx = shard_indices(len(batch.aug.shift), accum, r, n_ranks)
    aug = type(batch.aug)(*(a[idx] for a in batch.aug))
    return type(batch)(*(None if f is None else f[idx] for f in batch[:-1]),
                       aug)


def check_devices(n_ranks: int, device_type: str,
                  backend: str | None = None) -> None:
    """Raise ``ValueError`` when ``n_ranks`` ranks need more devices than
    are visible: NCCL runs one rank a GPU (the JAX package's ``make_mesh``
    raises a ``ValueError`` when the mesh exceeds the devices).  Gloo
    ranks may share a GPU, and on the CPU any number runs."""
    if device_type != 'cuda' or (backend or 'nccl') != 'nccl':
        return
    have = torch.cuda.device_count()
    if n_ranks > have:
        raise ValueError(f'a mesh of {n_ranks} devices exceeds the {have} '
                         f'visible GPU(s)')


def member_share(k: int, r: int, n_ranks: int) -> tuple:
    """Rank ``r``'s contiguous share of a member grid of ``k`` padded to a
    multiple of ``n_ranks``: ``(start, stop, per)`` with ``per =
    ceil(k / n_ranks)`` slots from ``r·per``, of which the members
    ``[start, stop)`` are real (the rest are the JAX package's dummy
    members: logvar +inf, posterior weight 0)."""
    per = -(-k // n_ranks)
    start = min(r * per, k)
    return start, min(start + per, k), per


def row_share(h: int, r: int, n_ranks: int, halo: int,
              align: int = 1) -> tuple:
    """Rank ``r``'s rows of a scene of ``h`` rows split evenly over
    ``n_ranks`` (the JAX package's ``space`` sharding, which needs ``h``
    divisible: ``ValueError`` otherwise): ``(r0, r1, s0, s1)``, the rows
    ``[r0, r1)`` it keeps and its slab ``[r0 - halo, r1 + halo) ∩ [0,
    h)``, its ends widened to multiples of ``align``."""
    if h % n_ranks:
        raise ValueError(f'a scene of {h} rows does not split evenly over '
                         f'{n_ranks} devices')
    per = h // n_ranks
    r0, r1 = r * per, (r + 1) * per
    return (r0, r1, max(0, (r0 - halo) // align * align),
            min(h, -(-(r1 + halo) // align) * align))


def _on_backend(t: torch.Tensor, op) -> torch.Tensor:
    """Run the in-place collective ``op`` on ``t`` (on a host copy under
    gloo for a CUDA tensor); returns the result."""
    if t.is_cuda and dist.get_backend() == 'gloo':
        host = t.cpu()
        op(host)
        return host.to(t.device)
    op(t)
    return t


def all_reduce_(t: torch.Tensor) -> torch.Tensor:
    """Sum ``t`` over ranks, no autograd; returns the sum (``t`` itself, or
    a new tensor under gloo for a CUDA ``t``)."""
    if world() == 1:
        return t
    return _on_backend(t, dist.all_reduce)


class _AllReduceSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t):
        return all_reduce_(t.clone())

    @staticmethod
    def backward(ctx, g):
        return all_reduce_(g.contiguous().clone())


def all_reduce_sum(t: torch.Tensor) -> torch.Tensor:
    """Σ over ranks of ``t``; the backward sums the cotangent over ranks
    (every rank's objective depends on every rank's ``t``)."""
    return t if world() == 1 else _AllReduceSum.apply(t)


class _AllGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t):
        n = world()
        t = t.contiguous()
        parts = [torch.empty_like(t) for _ in range(n)]
        if t.is_cuda and dist.get_backend() == 'gloo':
            host = [p.cpu() for p in parts]
            dist.all_gather(host, t.cpu())
            parts = [p.to(t.device) for p in host]
        else:
            dist.all_gather(parts, t)
        ctx.rows = t.shape[0]
        return torch.cat(parts)

    @staticmethod
    def backward(ctx, g):
        r = rank()
        return g[r * ctx.rows:(r + 1) * ctx.rows]


def all_gather(t: torch.Tensor) -> torch.Tensor:
    """Every rank's ``t`` concatenated on dim 0 in rank order (the global
    batch when ``t`` holds the rank's samples).  The backward returns the
    rank's own rows of the cotangent: each rank computes the whole global
    objective from the gathered tensor, so its own rows' cotangent is the
    global one."""
    return t if world() == 1 else _AllGather.apply(t)


@torch.no_grad()
def gather_dim(t: torch.Tensor, dim: int) -> torch.Tensor:
    """Every rank's ``t`` (equal shapes) concatenated on ``dim`` in rank
    order, no autograd."""
    if world() == 1:
        return t
    return all_gather(t.movedim(dim, 0)).movedim(0, dim)


def sum_gradients(params) -> None:
    """Sum every parameter's ``.grad`` over ranks, in one flat buffer."""
    if world() == 1:
        return
    grads = [p.grad for p in params if p.grad is not None]
    flat = all_reduce_(torch.cat([g.reshape(-1) for g in grads]))
    o = 0
    for g in grads:
        g.copy_(flat[o:o + g.numel()].view_as(g))
        o += g.numel()


def broadcast_module(module: torch.nn.Module) -> None:
    """Rank 0's parameters and buffers on every rank."""
    if world() == 1:
        return
    with torch.no_grad():
        for t in list(module.parameters()) + list(module.buffers()):
            data = t.data
            got = _on_backend(data, lambda x: dist.broadcast(x, 0))
            if got is not data:
                data.copy_(got)


def any_rank(flag: bool) -> bool:
    """True on every rank when ``flag`` is true on any."""
    if world() == 1:
        return flag
    dev = torch.device('cuda', torch.cuda.current_device()) \
        if dist.get_backend() == 'nccl' else torch.device('cpu')
    t = torch.tensor([1 if flag else 0], dtype=torch.int32, device=dev)
    dist.all_reduce(t, op=dist.ReduceOp.MAX)
    return bool(t.item())


def _rank_main(r, n_ranks, init_method, backend, device_type, fn, args,
               results):
    """One rank: join the group, run ``fn(*args)``, report to the parent."""
    try:
        dev = rank_device(device_type, r)
        if dev.type == 'cuda':
            torch.cuda.set_device(dev)
        else:
            # the ranks share the host's cores
            torch.set_num_threads(max(1, torch.get_num_threads() // n_ranks))
        dist.init_process_group(backend, init_method=init_method, rank=r,
                                world_size=n_ranks,
                                timeout=timedelta(seconds=COLLECTIVE_TIMEOUT_S))
        try:
            results.put((r, 'ok', fn(*args)))
        finally:
            dist.destroy_process_group()
    except BaseException:
        results.put((r, 'error', traceback.format_exc()))
        raise


def launch(fn, n_ranks: int, args=(), device_type: str = 'cpu',
           backend: str | None = None, timeout: float | None = None,
           store: str | None = None) -> list:
    """Run ``fn(*args)`` on ``n_ranks`` new processes in one group and
    return their results in rank order.

    Each rank runs on ``rank_device(device_type, r)``; the group meets
    through a file store in a fresh temporary directory under ``store``
    (default: the system's), so no port is raced for.  ``backend``
    defaults to NCCL on CUDA and gloo on the CPU.  A rank that raises, or
    a run past ``timeout`` seconds, stops every rank and raises here.  SIGTERM to this process is passed on to the ranks
    (each stops at the end of its step and checkpoints)."""
    backend = backend or ('nccl' if device_type == 'cuda' else 'gloo')
    ctx = torch.multiprocessing.get_context('spawn')
    store = tempfile.mkdtemp(prefix='mmlf_ranks_', dir=store)
    results = ctx.Queue()
    procs = [ctx.Process(target=_rank_main,
                         args=(r, n_ranks, f'file://{store}/rendezvous',
                               backend, device_type, fn, args, results),
                         daemon=True)
             for r in range(n_ranks)]
    def forward_sigterm(_signum, _frame):
        for p in procs:
            if p.is_alive():
                os.kill(p.pid, signal.SIGTERM)

    prev = None
    if threading.current_thread() is threading.main_thread():
        prev = signal.signal(signal.SIGTERM, forward_sigterm)
    done = {}
    try:
        for p in procs:
            p.start()
        deadline = None if timeout is None else time.time() + timeout
        while len(done) < n_ranks:
            if deadline is not None and time.time() > deadline:
                raise TimeoutError(f'{n_ranks} ranks did not finish in '
                                   f'{timeout} s')
            try:
                r, status, value = results.get(timeout=1.0)
            except queue.Empty:
                dead = [p.exitcode for p in procs
                        if p.exitcode not in (None, 0)]
                if dead:
                    raise RuntimeError(f'a rank exited with code {dead[0]} '
                                       f'without a result')
                continue
            if status == 'error':
                raise RuntimeError(f'rank {r} failed:\n{value}')
            done[r] = value
        for p in procs:
            p.join(timeout=60)
    finally:
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join(timeout=10)
        if prev is not None:
            signal.signal(signal.SIGTERM, prev)
        results.close()
        shutil.rmtree(store, ignore_errors=True)
    return [done[r] for r in range(n_ranks)]
