"""Training loop: the input path, forward, backward and Adam per step,
schedules, in-train validation, the log and the rolling checkpoint.

The counterpart of ``mmlf_tpu.train.loop`` (which reproduces the reference
``mmlf/train/cli.py``):

  * an unbounded step loop over a virtual-length-4096 dataset
    (``cfg.train_steps`` bounds it);
  * index-only batches from the device-resident scene pyramid
    (``data/pipeline.DevicePipeline``); each microbatch is cut by kernel
    K1 and augmented on the device (``gather_augment``).  With
    ``--host_pipeline``, or when the scene cache would take 8 GiB or more,
    or the scenes differ in shape (the JAX package's switch), the host
    pipeline instead: ``TrainPipeline.sample_batch`` cuts the windows on
    the host, the batch is copied to the card once a step and each
    microbatch is augmented there at once (``augment_host_batch``);
  * margin-11 train mask, strongest-mode GT, discrete targets and the
    loss-padding masks (``prepare_targets``); head-dependent losses with
    the logvar warm-up and anchor (``compute_loss``);
  * gradient accumulation over ``train_accum`` microbatches: the chunk
    losses and gradients are averaged uniformly, or weighted by their mask
    counts under ``--train_accum_exact``; the BatchNorm running statistics
    are those of chunk 0;
  * ``--pallas_trunk``: the train-mode forward and backward of every conv
    block (streams and out_net) run through kernel K3
    (``models/pallas_trunk.py``); eval and in-train validation keep the
    plain path, and so does ``--train_eval_mode`` (the model in eval mode);
  * ``torch.optim.Adam(betas=(0.9, 0.999), eps=1e-8)`` with the scheduled
    LR (warm-start ramp, cooling decay) written into the param group before
    each step: what ``optax.scale_by_adam`` with ``-lr·u`` computes;
  * validation at ``i % val_interval == 0`` on the unshifted val scenes
    (``validate/cli.make_scene_eval``), the artifact dump and the rolling
    ``checkpoint.pt``, written through an asynchronous ``ModelSaver`` (the
    loop blocks for the host snapshot; ``close()`` drains the writer in
    ``finally``, and a write error never replaces an exception already
    raised);
  * the ``log.csv`` columns of the reference, emitted through a 3-step lag
    ring (0 with ``--train_nan_guard``), the first row's time the absolute
    unix time (reference quirk);
  * a checkpoint on SIGTERM and on completion; ``--train_resume`` restores
    model, optimizer and iteration and reseeds the sampler from
    ``SeedSequence([train_seed, iteration])``;
  * ``--mesh_data N`` (0, the default: every visible GPU; 1 on the CPU):
    N ranks (``parallel/mesh.launch``: NCCL, one rank a GPU; gloo on the
    CPU) train one global batch as the JAX package's data mesh does.
    Every rank draws the same global batch from the same seed and takes
    its samples of each microbatch; K1 cuts them from the rank's own
    replica of the scene cache; BatchNorm statistics (plain and K3's sums)
    are the global batch's; each rank gathers the outputs and targets and
    computes the global loss, and the parameter gradients are summed over
    the ranks once per step.  Rank 0 alone writes the log, validates and
    checkpoints.  As in the JAX package, N above the visible GPUs or a
    batch (here also a microbatch) that does not divide over N prints a
    warning and trains on one device.

Runs on the card by default (``device='cuda'``) in float32 with TF32 off;
``--bf16`` runs the conv trunk in bfloat16 (plain or through K3's bf16
instance under ``--pallas_trunk``), ``--cache_bf16`` keeps the image
levels of the scene pyramid in bfloat16 (K1 cuts bf16 windows), and
``--remat`` recomputes the plain trunk's blocks in the backward
(``--cache_bf16`` does nothing on the host pipeline, as in the JAX
package).  ``--model_unet`` replaces the out_net by the U-Net
(``models/unet.py``); ``--pallas_trunk`` is then ignored, as in the JAX
package.  ``--model_inn`` trains the invertible network
(``models/inn.py``) on the information-bottleneck loss against
``reg_to_class`` targets over ``cfg.steps`` bins (train and val loss),
from the device cache with K1 or from the host pipeline as any model;
``--pallas_trunk`` and ``--remat`` do nothing for it and
``--train_accum_exact`` is refused, as in the JAX package; under
``--mesh_data`` each rank gathers ``dists`` and ``jac`` for the global
loss.  ``--model_invertible`` raises, as upstream.
"""

from __future__ import annotations

import collections
import os
import random
import signal
import sys
import threading
import time
from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch

from ..config import Config
from ..data.hci4d import HCI4D
from ..data.pipeline import (DevicePipeline, PackedCache, TrainPipeline,
                             augment_host_batch, batch_to_device,
                             chunk_slice, gather_augment, window_size)
from ..losses import (improved_multi_uncertainty_l1, improved_uncertainty_l1,
                      information_bottleneck, logvar_anchor,
                      masked_cross_entropy, masked_l1, multi_masked_l1)
from ..models import build_model, init_model_
from ..models.invertible import NOT_SUPPORTED_MSG
from ..ops.codecs import mpi_to_weights, reg_to_class
from ..ops.masks import create_mask_margin
from ..parallel import mesh
from ..utils.device import resolve_device
from ..validate.cli import make_scene_eval, scene_to_device
from .checkpoint import ModelSaver, has_checkpoint, load_checkpoint

LOG_HEADER = (f'{"iter":>7}, loss_train,   loss_val,        mse, '
              'badpix_007, time_elapsed')
# the JAX package trains from its host pipeline from this cache size on
DEVICE_CACHE_LIMIT = 8 << 30


def check_ported(cfg: Config) -> None:
    """Raise for ``--model_invertible``, dead upstream, as the JAX package
    raises."""
    if cfg.model_invertible:
        raise NotImplementedError(NOT_SUPPORTED_MSG)


def lr_schedule(cfg: Config, step: int) -> float:
    """Warm-start ramp (lr·i/1000 while i ≤ 1000) and cooling decay
    (lr/10^(i/cool − 1) from i ≥ cool), in float32 as the JAX package
    computes them."""
    step = np.float32(step)
    lr = np.float32(cfg.train_lr)
    if cfg.train_warm_start and step <= 1000.0:
        lr = np.float32(cfg.train_lr) * step / np.float32(1000.0)
    if cfg.train_cooling > 0 and step >= cfg.train_cooling:
        cool = np.float32(cfg.train_cooling)
        lr = np.float32(cfg.train_lr) / np.float32(10.0) ** (
            step / cool - np.float32(1.0))
    return float(lr)


def prepare_targets(cfg: Config, gt, mpi, mask):
    """Targets and masks of one microbatch: strongest-mode GT, the margin-11
    train mask, discrete targets and the loss-padding masks.  Returns
    ``(gt, mpi, gt_classes, mask, mask_padding)``."""
    if cfg.train_loss_strongest:
        inds = torch.argmax(mpi[..., 3], dim=1)               # (b, P, P)
        gt = torch.take_along_dim(mpi[..., 4], inds[:, None], dim=1)[:, 0]

    margin = create_mask_margin(mask.shape[-2:], 11, mask.device)
    mask = mask.to(torch.int32) * margin.to(torch.int32)

    gt_classes = None
    if cfg.model_discrete or cfg.model_inn:
        if cfg.train_loss_multimodal and not cfg.model_inn:
            gt_classes = mpi_to_weights(mpi, cfg.val_disp_min,
                                        cfg.val_disp_max, cfg.steps)
        else:
            # the INN's cluster count is cfg.steps
            gt_classes = reg_to_class(gt, cfg.val_disp_min,
                                      cfg.val_disp_max, cfg.steps)

    mask_padding = None
    if cfg.train_loss_padding is not None:
        pad = float(cfg.train_loss_padding)
        if cfg.train_loss_multimodal:
            keep = (torch.abs(mpi[..., 4]) < pad).float()
            mpi = torch.cat([mpi[..., :3], mpi[..., 3:4] * keep[..., None],
                             mpi[..., 4:]], dim=-1)
        else:
            mask_padding = (torch.abs(gt) < pad).to(torch.int32)
    return gt, mpi, gt_classes, mask, mask_padding


def compute_loss(cfg: Config, output: dict, gt, mpi, gt_classes, mask,
                 mask_padding, step: Optional[int] = None):
    """Head-dependent training loss.  ``--train_logvar_warmup N`` scales the
    logvar the uncertainty losses see by ``min(step/N, 1)``;
    ``--train_logvar_anchor`` adds the calibration anchor on the unscaled
    logvar."""
    anchor = 0.0
    if cfg.model_uncert and cfg.train_logvar_anchor > 0:
        anchor = cfg.train_logvar_anchor * logvar_anchor(
            output, gt, mpi, mask, mask_padding,
            multimodal=cfg.train_loss_multimodal)
    if cfg.model_uncert and cfg.train_logvar_warmup > 0 and \
            step is not None:
        w = min(np.float32(step) / np.float32(cfg.train_logvar_warmup),
                np.float32(1.0))
        output = dict(output, logvar=output['logvar'] * float(w))
    if cfg.model_inn:
        # the IB loss ignores the mask, as the reference's does
        return information_bottleneck(output, gt_classes, cfg.train_beta)
    if cfg.model_uncert:
        if cfg.train_loss_multimodal:
            return anchor + improved_multi_uncertainty_l1(
                output, mpi, mask, mask_padding)
        return anchor + improved_uncertainty_l1(output, gt, mask,
                                                mask_padding)
    if cfg.model_discrete:
        return masked_cross_entropy(output, gt_classes, mask)
    if cfg.model_invertible:
        raise NotImplementedError(NOT_SUPPORTED_MSG)
    if cfg.train_loss_multimodal:
        return multi_masked_l1(output, mpi, mask)
    return masked_l1(output, gt, mask)


def val_loss(cfg: Config, output: dict, gt, mpi, mask):
    """Validation loss of the head."""
    if cfg.model_inn:
        target = reg_to_class(gt, cfg.val_disp_min, cfg.val_disp_max,
                              cfg.steps)
        return information_bottleneck(output, target, cfg.train_beta)
    if cfg.model_uncert:
        if cfg.train_loss_multimodal:
            return improved_multi_uncertainty_l1(output, mpi, mask)
        return improved_uncertainty_l1(output, gt, mask)
    if cfg.train_loss_multimodal:
        return multi_masked_l1(output, mpi, mask)
    return masked_l1(output, gt, mask)


def check_accum(cfg: Config) -> None:
    """``--train_accum_exact`` weights every chunk by one mask count; raise
    where a loss term normalizes by another count, with the JAX package's
    guards.  Like the JAX package it accepts the multimodal uncertainty
    loss without an anchor, though that loss divides by the chunk's mean
    plane weight, a per-chunk normalizer (the inexactness ``ADVICE.md``
    records)."""
    if not (cfg.train_accum_exact and cfg.train_accum > 1):
        return
    if cfg.train_loss_padding is not None:
        raise ValueError(
            '--train_accum_exact is incompatible with --train_loss_padding: '
            'the in/out-of-range two-term loss has no single mask count')
    if cfg.model_inn:
        raise ValueError(
            '--train_accum_exact does not apply to the INN: its IB loss '
            'ignores the mask, and equal-sized chunks make the default '
            'uniform averaging already exact')
    if cfg.model_uncert and cfg.train_logvar_anchor > 0 and \
            cfg.train_loss_multimodal:
        raise ValueError(
            '--train_accum_exact with a multimodal logvar anchor is '
            'unsupported: the anchor normalizes over mask∧in-range, a '
            'different count than the main loss')


def with_mpi(cfg: Config) -> bool:
    """MPI windows are only cut and copied when a loss reads them."""
    return bool(cfg.train_loss_multimodal or cfg.train_loss_strongest)


def microbatch_loss(cfg: Config, model: torch.nn.Module,
                    cache: Optional[PackedCache], chunk, step: int):
    """Input path + forward + loss of one microbatch: a ``DeviceBatch`` cut
    from ``cache`` by K1, or (no cache) a host ``Batch`` already on the
    device.  Returns ``(loss, mask count)``; the caller runs the
    backward.  Under data parallel ``chunk`` is the rank's part of the
    microbatch, and the loss and count are the whole microbatch's (the
    outputs and targets gathered from every rank)."""
    if cache is None:
        h, v, i, d, gt, mpi, mask = augment_host_batch(chunk, cfg.train_ps)
    else:
        h, v, i, d, gt, mpi, mask = gather_augment(
            cache, chunk, cfg.train_ps, window_size(cfg.train_ps),
            with_mpi=with_mpi(cfg))
    output = model(h, v, i, d, folded=True)
    if mesh.world() > 1:
        if cfg.model_inn:
            # the IB loss reads every sample's dists and jac, and zixels'
            # H, W and mu, the same on every rank
            output = dict(output, dists=mesh.all_gather(output['dists']),
                          jac=mesh.all_gather(output['jac']))
        else:
            output = {k: mesh.all_gather(output[k])
                      for k in ('mean', 'logvar', 'scores')
                      if output.get(k) is not None}
        gt, mask = mesh.all_gather(gt), mesh.all_gather(mask)
        mpi = None if mpi is None else mesh.all_gather(mpi)
    gt, mpi, gt_classes, mask, mask_padding = prepare_targets(cfg, gt, mpi,
                                                              mask)
    loss = compute_loss(cfg, output, gt, mpi, gt_classes, mask,
                        mask_padding, step=step)
    return loss, torch.sum(mask).float()


def train_step(cfg: Config, model: torch.nn.Module, optimizer, cache, batch,
               step: int, bn_train: bool = True) -> torch.Tensor:
    """One optimizer step over ``batch`` (``train_accum`` microbatches): a
    ``DeviceBatch`` of ``cache``, or a host ``Batch`` on the device when
    ``cache`` is None (under data parallel, the rank's part of the global
    batch: ``mesh.shard_batch``).  ``bn_train=False`` is
    ``--train_eval_mode`` (running statistics, no updates).  Returns the
    step's loss as a 0-d device tensor."""
    check_accum(cfg)
    accum = max(1, int(cfg.train_accum))
    exact = bool(cfg.train_accum_exact) and accum > 1
    n = len(batch.aug.shift)
    if n % accum:
        raise ValueError(f'batch {n} does not split into {accum} '
                         f'microbatches')
    size = n // accum
    # an INN's subnet BatchNorm runs on its running statistics under
    # --model_no_batchnorm, as the JAX step applies it with train=False
    model.train(bn_train and not (cfg.model_inn and cfg.model_no_batchnorm))
    optimizer.zero_grad(set_to_none=True)

    total = n_total = 0.0
    stats0 = None
    for c in range(accum):
        loss_c, n_c = microbatch_loss(cfg, model, cache,
                                      chunk_slice(batch, c * size,
                                                  (c + 1) * size), step)
        w = n_c if exact else 1.0 / accum
        (loss_c * w).backward()
        total = total + w * loss_c.detach()
        n_total = n_total + n_c
        if c == 0 and accum > 1:
            # the running statistics of chunk 0 are the step's (the fused
            # trunk updates the same BN buffers in place)
            stats0 = [b.detach().clone() for b in model.buffers()]
    mesh.sum_gradients(model.parameters())
    if stats0 is not None:
        with torch.no_grad():
            for b, b0 in zip(model.buffers(), stats0):
                b.copy_(b0)
    if exact:
        norm = torch.clamp(n_total, min=1.0)
        total = total / norm
        for p in model.parameters():
            p.grad.div_(norm)

    lr = lr_schedule(cfg, step)
    for group in optimizer.param_groups:
        group['lr'] = lr
    optimizer.step()
    return total


def make_optimizer(model: torch.nn.Module) -> torch.optim.Adam:
    """Adam with torch's moments; the LR is written before each step."""
    return torch.optim.Adam(model.parameters(), lr=0.0, betas=(0.9, 0.999),
                            eps=1e-8)


@dataclass
class TrainState:
    """What ``train`` returns: the model, its optimizer and the number of
    completed steps; after a data-parallel run, the final checkpoint's
    model and optimizer and each rank's report (``ranks``: its steps and
    the kernel launches it counted)."""
    model: torch.nn.Module
    optimizer: torch.optim.Adam
    step: int
    ranks: Optional[list] = None


def data_parallel_size(cfg: Config, dev: torch.device) -> int:
    """The number of ranks ``--mesh_data`` asks for, or 1 with the JAX
    package's loud warning when it cannot be had: more ranks than visible
    GPUs, or a batch that does not divide over them (here also a
    microbatch: every rank takes an equal part of each).  0 means every
    visible GPU; on the CPU, 1 (any N runs N ranks there)."""
    n_dev = torch.cuda.device_count() if dev.type == 'cuda' else None
    n = cfg.mesh_data if cfg.mesh_data else (n_dev or 1)
    if n <= 1:
        return 1
    accum = max(1, int(cfg.train_accum))
    why = None
    if n_dev is not None and n > n_dev:
        why = f'mesh size {n} exceeds the {n_dev} local device(s)'
    elif cfg.train_bs % n:
        why = f'batch size {cfg.train_bs} does not divide over {n} devices'
    elif cfg.train_bs % accum == 0 and (cfg.train_bs // accum) % n:
        why = (f'microbatch size {cfg.train_bs // accum} does not divide '
               f'over {n} devices')
    if why is None:
        return n
    # a degraded-but-running fallback must be loud: an unnoticed
    # single-device run on an N-device host burns N× step time
    print(f'WARNING: data-parallel mesh disabled ({why}); training '
          f'single-device', file=sys.stderr)
    return 1


def _rank_train(cfg: Config, output_dir: str, progress: bool,
                device_type: str, initial_state: Optional[dict]) -> dict:
    """One rank of ``train_ranks`` (in its own process and group)."""
    from ..ops.kernels import launch_counts
    dev = mesh.rank_device(device_type, mesh.rank())
    state = train(cfg, output_dir, progress=progress, device=dev,
                  initial_state=initial_state)
    return {'rank': mesh.rank(), 'step': state.step,
            'launches': launch_counts()}


def train_ranks(cfg: Config, output_dir: str, n_ranks: int, device='cuda',
                backend: Optional[str] = None, progress: bool = True,
                initial_state: Optional[dict] = None,
                timeout: Optional[float] = None) -> TrainState:
    """Train on ``n_ranks`` new processes (``mesh.launch``): NCCL with one
    rank a GPU by default on CUDA, gloo on the CPU; ``backend='gloo'``
    lets several ranks share a GPU.  Returns the final checkpoint's state
    on ``device``, with each rank's report."""
    dev = resolve_device(device)
    reports = mesh.launch(_rank_train, n_ranks,
                          (cfg, output_dir, progress, dev.type,
                           initial_state),
                          device_type=dev.type, backend=backend,
                          timeout=timeout)
    ckpt = load_checkpoint(output_dir)
    model = build_model(cfg)
    model.load_state_dict(ckpt['model_state_dict'], strict=True)
    model.to(dev)
    optimizer = make_optimizer(model)
    optimizer.load_state_dict(ckpt['optimizer_state_dict'])
    return TrainState(model=model, optimizer=optimizer,
                      step=int(ckpt['iteration']), ranks=reports)


def train(cfg: Config, output_dir: str, progress: bool = True,
          device='cuda', initial_state: Optional[dict] = None) -> TrainState:
    """Run the training loop; returns the final state.

    ``cfg.train_steps > 0`` bounds the loop; 0 runs forever like the
    reference.  ``initial_state`` (a state dict of the port's model,
    e.g. ``utils/convert.state_dict_from_jax`` of a JAX init) replaces the
    seeded initialization of a fresh run.  With ``--mesh_data`` (see
    ``data_parallel_size``) the run goes to ``train_ranks``; inside a rank
    this function is that rank's loop.
    """
    if cfg.train_loss_strongest and cfg.train_loss_multimodal:
        raise ValueError('--train_loss_strongest and '
                         '--train_loss_multimodal exclude each other')
    check_ported(cfg)
    dev = resolve_device(device)
    n_ranks, lead = mesh.world(), mesh.rank() == 0
    if n_ranks == 1:
        n = data_parallel_size(cfg, dev)
        if n > 1:
            return train_ranks(cfg, output_dir, n, dev.type,
                               progress=progress, initial_state=initial_state)
    accum = max(1, int(cfg.train_accum))
    progress = progress and lead

    # a resumed run draws a fresh deterministic sample stream, seeded from
    # (train_seed, iteration) through a SeedSequence
    resume = None
    resume_i = 0
    if cfg.train_resume and has_checkpoint(output_dir):
        resume = load_checkpoint(output_dir)
        resume_i = int(resume['iteration'])
    rng_seed = cfg.train_seed if resume_i == 0 else int(
        np.random.SeedSequence([cfg.train_seed, resume_i])
        .generate_state(1)[0])
    # the transforms library draws from the stdlib and numpy globals;
    # pinned, as the JAX package pins them, so --train_seed reproduces a
    # run (the pipelines draw from their own seeded generator)
    random.seed(rng_seed)
    np.random.seed(rng_seed)

    trainset = HCI4D(cfg.train_trainset, cache=True, length=4096)
    # the device-resident pyramid unless forced off, too large or ragged
    scene_bytes = sum(
        sum(a.nbytes for a in (d[0], d[1], d[2], d[3], d[5], d[6], d[7]))
        for d in trainset.data)
    use_device_cache = not cfg.host_pipeline and \
        scene_bytes < DEVICE_CACHE_LIMIT and \
        len({d[5].shape for d in trainset.data}) == 1
    if use_device_cache:
        pipeline = DevicePipeline(trainset, cfg, seed=rng_seed, device=dev)
        cache = pipeline.cache
    else:
        pipeline = TrainPipeline(trainset, cfg, seed=rng_seed)
        cache = None
    # no transform: in-train validation feeds UNSHIFTED scenes even when
    # train_shift != 0, like the reference and the JAX package; only rank 0
    # validates
    valset = HCI4D(cfg.train_valset, cache=True) if lead else None

    model = build_model(cfg)
    if initial_state is not None:
        model.load_state_dict(initial_state, strict=True)
    else:
        init_model_(model, cfg.train_seed)
    model.to(dev)
    mesh.broadcast_module(model)
    optimizer = make_optimizer(model)

    i = 0
    if resume is not None:
        print('Resume training...')
        model.load_state_dict(resume['model_state_dict'], strict=True)
        optimizer.load_state_dict(resume['optimizer_state_dict'])
        i = resume_i
        resume = None

    scene_eval = make_scene_eval(model, cfg, cfg.to_dict(), cfg.val_ensamble,
                                 cfg.val_disp_min, cfg.val_disp_max,
                                 cfg.val_disp_step, cfg.val_loss_margin)

    # rank 0 alone writes the log, validates and checkpoints
    model_saver = ModelSaver() if lead else None
    log = open(os.path.join(output_dir, 'log.csv') if lead else os.devnull,
               'a' if cfg.train_resume else 'w')
    if progress:
        print(LOG_HEADER)
    if not cfg.train_resume:
        print(LOG_HEADER, file=log)

    loss_val_avg = mse_avg = bad_pix_avg = 0.0
    # time_elapsed is measured between row emits (a row's loss readback
    # waits for its step); the first row holds the absolute unix time, the
    # reference's quirk
    time_start = 0.0
    profiler = None
    # rows are emitted log_lag steps late so the card always has the next
    # step queued; --train_nan_guard reads every loss at once
    log_lag = 0 if cfg.train_nan_guard else 3
    pending = collections.deque()   # (step, loss tensor, val snapshot)

    def emit_row(row):
        nonlocal time_start
        j, loss_dev, lv, ms, bp = row
        loss_f = float(loss_dev)    # waits for step j
        now = time.time()
        dt = now - time_start
        time_start = now
        line = (f'{j:>7}, {loss_f:.8f}, {lv:.8f}, '
                f'{ms:.8f}, {bp:.8f}, {dt:.8f}')
        if progress:
            print(line)
        print(line, file=log, flush=True)

    def save_rolling_checkpoint():
        """The rolling checkpoint at the loop's current (model, i): the
        val-interval save runs before ``i += 1`` (resume re-runs step i,
        the reference's replay), the SIGTERM and completion saves after it
        (resume continues at the next step)."""
        if not lead:
            return
        epoch = i // max(1, len(trainset) // cfg.train_bs)
        model_saver(output_dir, model, optimizer, cfg, epoch, i,
                    loss_val_avg)

    term_event = None
    prev_term = None
    if cfg.train_term_checkpoint and \
            threading.current_thread() is threading.main_thread():
        term_event = threading.Event()
        prev_term = signal.signal(signal.SIGTERM,
                                  lambda _s, _f: term_event.set())

    try:
        while True:
            if cache is None:
                batch = pipeline.sample_batch(cfg.train_bs,
                                              pin_memory=dev.type == 'cuda')
            else:
                batch = pipeline.sample_batch(cfg.train_bs)
            if n_ranks > 1:
                batch = mesh.shard_batch(batch, mesh.rank(), n_ranks, accum)
            if cache is None:
                batch = batch_to_device(batch, dev, with_mpi(cfg))
            eval_mode = cfg.train_eval_mode and i >= cfg.train_eval_mode_start
            if cfg.train_profile and i == 10 and lead:
                profiler = _start_profiler(dev)
            loss_train = train_step(cfg, model, optimizer, cache, batch, i,
                                    bn_train=not eval_mode)
            if profiler is not None and i >= 15:
                _stop_profiler(profiler, output_dir, dev)
                profiler = None

            if cfg.train_nan_guard and not np.isfinite(float(loss_train)):
                raise FloatingPointError(
                    f'non-finite training loss at step {i}: '
                    f'{float(loss_train)}')

            if i % cfg.val_interval == 0 and lead:
                # flush lagged rows first so validation never lands inside
                # a training row's time_elapsed
                while pending:
                    emit_row(pending.popleft())
                loss_val_avg, mse_avg, bad_pix_avg = _validate(
                    cfg, model, valset, scene_eval, output_dir, dev)
                save_rolling_checkpoint()
                # keep the validation out of the next row's clock (but keep
                # the first row's unix-time quirk)
                if time_start:
                    time_start = time.time()

            if lead:
                pending.append((i, loss_train, loss_val_avg, mse_avg,
                                bad_pix_avg))
            while len(pending) > log_lag:
                emit_row(pending.popleft())

            i += 1
            # the ranks stop together: at a step's end, when any has a
            # SIGTERM
            if mesh.any_rank(term_event is not None and
                             term_event.is_set()):
                while pending:
                    emit_row(pending.popleft())
                save_rolling_checkpoint()
                if lead:
                    print(f'SIGTERM: checkpoint written after step {i - 1} '
                          f'({i} steps completed); exiting cleanly '
                          f'(continue with --train_resume)', file=sys.stderr)
                break
            if cfg.train_steps and i >= cfg.train_steps:
                # persist the completed state (stamp == train_steps)
                save_rolling_checkpoint()
                break
        while pending:
            emit_row(pending.popleft())
    finally:
        # drain the checkpoint writer; an exception on its way up stays
        # the visible one, and a write error close() raises beside it is
        # only reported
        in_flight = sys.exc_info()[0] is not None
        try:
            if model_saver is not None:
                model_saver.close()
        except RuntimeError as exc:
            if not in_flight:
                raise
            print(f'checkpoint writer failed during shutdown: {exc!r}',
                  file=sys.stderr)
        finally:
            pipeline.close()
            if profiler is not None:
                _stop_profiler(profiler, output_dir, dev)
            if term_event is not None:
                signal.signal(signal.SIGTERM,
                              prev_term if prev_term is not None
                              else signal.SIG_DFL)
            log.close()
    return TrainState(model=model, optimizer=optimizer, step=i)


@torch.no_grad()
def _validate(cfg: Config, model: torch.nn.Module, valset: HCI4D, scene_eval,
              output_dir: str, dev):
    """Full-scene eval of every val scene (running BN statistics); writes
    the artifacts and returns the mean (loss_val, mse, badpix)."""
    model.eval()
    loss_val = mse = bad_pix = 0.0
    for j in range(len(valset.scenes)):
        sample = valset[j]
        stacks, gt, mpi = scene_to_device(sample, dev)
        output, metrics = scene_eval(*stacks, gt, mpi)
        mask = create_mask_margin(gt.shape, cfg.val_loss_margin, dev)
        loss_val += float(val_loss(cfg, output, gt, mpi, mask))
        mse += float(metrics['mse'])
        bad_pix += float(metrics['bad_pix'])
        logvar = output.get('logvar')
        valset.save_batch(output_dir, np.asarray(sample[8])[None],
                          output['mean'].cpu().numpy(),
                          None if logvar is None else logvar.cpu().numpy())
    n = len(valset.scenes)
    return loss_val / n, mse / n, bad_pix / n


def _start_profiler(dev):
    activities = [torch.profiler.ProfilerActivity.CPU]
    if dev.type == 'cuda':
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    profiler = torch.profiler.profile(activities=activities)
    profiler.__enter__()
    return profiler


def _stop_profiler(profiler, output_dir: str, dev) -> None:
    if dev.type == 'cuda':
        torch.cuda.synchronize(dev)
    profiler.__exit__(None, None, None)
    path = os.path.join(output_dir, 'profile')
    os.makedirs(path, exist_ok=True)
    profiler.export_chrome_trace(os.path.join(path, 'trace.json'))
    print(f'profiler trace written to {path}')
