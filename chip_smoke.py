#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one CUDA card.

    python3 chip_smoke.py

Phases, in order; any failure exits non-zero and prints no result:

1. card    — the card's name and power limit (nvidia-smi);
2. build   — every CUDA kernel of mmlf_tpu_torch/csrc, one nvcc each,
             started together, with each kernel's ptxas report;
3. data    — 4 synthetic 512² train scenes (seeds 0-3) and one val scene
             (seed 7), one process each;
4. train   — the README UPR recipe through the train CLI at full width
             (chs 70, 3+8 blocks, 9 views): bs 512 as 8 microbatches of
             64, ps 96, train_shift 2.5, warm-start LR 1e-3, TRAIN_STEPS
             steps, validation at step 0; checks the log rows, the
             checkpoint and that kernel K1 launched steps × accum times,
             then holds K1 against its plain version on the run's own last
             batch; prints s/step, patches/s, conv TFLOP/s, peak memory;
5. K1      — the window gather against its plain version at the recipe
             shape (64 windows of 128², all four levels, with and without
             the MPI field), its time, the plain version's, one
             advanced-indexing call's, and the bound; the augmentation's
             and the host sampler's time;
6. main    — ESE validation of the train phase's checkpoint through the
             validate CLI on the val scene, 70 members; checks the
             metrics, the artifacts and that K2 launched once; then holds
             K2 against its plain version on the run's own members;
7. K2      — the mixture posterior against its plain version at the ESE
             shape, its time, the plain version's and the bound;
8. member / breakdown — device time of one ESE member and host times of
             the validate path's other pieces;
9. the kernels line (JSON), the card line, and the last line
   ``{"ok": true, "device": {...}}``.

The weights start random (seeded) and train 4 steps, so the accuracy
numbers printed mean nothing; the run shows that the port builds, agrees
with its plain versions and runs both halves of the main path on the card.
Imports nothing of JAX or of mmlf_tpu.
"""

from __future__ import annotations

import json
import math
import os
import re
import shutil
import subprocess
import sys
import time

REPO = os.path.dirname(os.path.abspath(__file__))
SIZE = 512
TRAIN_SCENES = 4
TRAIN_STEPS = 4
# the README UPR recipe (bs 512 as 8 microbatches of 64)
RECIPE = ['--train_shift', '2.5', '--train_lr', '1e-3', '--train_bs', '512',
          '--train_ps', '96', '--train_warm_start', '--model_uncert',
          '--train_accum', '8']
# H100 SXM peaks (NVIDIA data sheet, dense): HBM bytes/s, fp32 FLOP/s
# outside the tensor cores
PEAK_BYTES = 3.35e12
PEAK_FP32 = 67e12
SFU_PER_SM_CLK = 16          # MUFU.EX2 results per SM per clock (Hopper)
TOL = dict(rtol=1e-4, atol=1e-6)   # ex2.approx on a pre-scaled argument


def log(*args):
    print(*args, flush=True)


def smi(query: str) -> str:
    out = subprocess.run(['nvidia-smi', f'--query-gpu={query}',
                          '--format=csv,noheader'], capture_output=True,
                         text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, reps: int, warmup: int = 2) -> float:
    """Mean device time of ``fn`` over ``reps`` calls (CUDA events)."""
    import torch
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def posterior_bound(k: int, p: int, kb: int):
    """Least time for the mixture posterior on the card: bytes (two (K, P)
    reads, the bins, one (P, Kb) write) over HBM rate vs fp32 operations
    (per term: sub, mul, exp, fma = 5; per member and pixel: rcp and two
    muls) over the fp32 peak."""
    n_bytes = 4 * (2 * k * p + kb + p * kb)
    n_ops = 5 * k * kb * p + 3 * k * p
    t_bytes, t_ops = n_bytes / PEAK_BYTES, n_ops / PEAK_FP32
    return (max(t_bytes, t_ops) * 1e3,
            'bytes' if t_bytes >= t_ops else 'operations')


def conv_flop_per_pixel() -> int:
    """Forward FLOP per output pixel of the full-width net: 4 streams of
    one 27→70 and five 70→70 k=2 convs, then 7 out_net blocks of two
    280→280 convs (the 280→2 head is left out)."""
    return 4 * (2 * 4 * 27 * 70 + 5 * 2 * 4 * 70 * 70) + \
        7 * 2 * 2 * 4 * 280 * 280


def check_close(got, want, what: str) -> float:
    import torch
    err = float((got - want).abs().max())
    torch.testing.assert_close(got, want, **TOL, msg=lambda m: f'{what}: {m}')
    return err


def phase_kernel(K) -> dict:
    """K2 against its plain version at the ESE shape (K = Kb = 70,
    P = 512²), seeded numpy inputs."""
    import numpy as np
    import torch
    k, p = 70, SIZE * SIZE
    rng = np.random.default_rng(0)
    dev = torch.device('cuda')
    means = torch.from_numpy(
        rng.uniform(-3.5, 3.5, (k, p)).astype(np.float32)).to(dev)
    scales = torch.exp(torch.from_numpy(
        rng.uniform(-3.0, 1.0, (k, p)).astype(np.float32)).to(dev))
    bins = torch.from_numpy(
        np.linspace(-3.5, 3.5, k).astype(np.float32)).to(dev)

    got = K.laplace_mixture_posterior(means, scales, bins)
    want = K.plain_mixture_posterior(means, scales, bins)
    torch.cuda.synchronize()
    err = check_close(got, want, 'mixture posterior vs plain (seeded)')
    ms = cuda_ms(lambda: K.laplace_mixture_posterior(means, scales, bins),
                 reps=20)
    plain_ms = cuda_ms(lambda: K.plain_mixture_posterior(means, scales,
                                                         bins), reps=3)
    bound_ms, bound_by = posterior_bound(k, p, k)
    props = torch.cuda.get_device_properties(0)
    clock_mhz = float(smi('clocks.max.sm').split()[0])
    sfu_ms = k * k * p / (props.multi_processor_count * SFU_PER_SM_CLK
                          * clock_mhz * 1e6) * 1e3
    log(f'kernel laplace_mixture_posterior K={k} P={p} Kb={k}: '
        f'{ms:.4f} ms, plain {plain_ms:.3f} ms, bound {bound_ms:.4f} ms '
        f'({bound_by}), exp-unit estimate {sfu_ms:.4f} ms '
        f'({props.multi_processor_count} SMs at {clock_mhz:.0f} MHz), '
        f'max abs err {err:.3e} (tolerance rtol {TOL["rtol"]}, '
        f'atol {TOL["atol"]})')
    return {'max_abs_err': err, 'ms': ms, 'plain_ms': plain_ms,
            'bound_ms': bound_ms, 'bound_by': bound_by}


def _make_scene(root: str, seed: int, name: str) -> None:
    """One synthetic 512² scene, ``generate_dataset(seed=seed)``'s only
    scene, written as ``root/name`` (a worker process)."""
    sys.path.insert(0, REPO)
    from mmlf_tpu_torch.data.synth import generate_dataset
    tmp = os.path.join(root, f'.{name}')
    generate_dataset(tmp, scenes=1, size=SIZE, seed=seed)
    os.replace(os.path.join(tmp, 'scene_00'), os.path.join(root, name))
    os.rmdir(tmp)


def phase_data(work: str):
    """Train scenes (seeds 0..3) and the val scene (seed 7), one process
    each."""
    import multiprocessing
    train, val = os.path.join(work, 'train'), os.path.join(work, 'val')
    os.makedirs(train)
    os.makedirs(val)
    jobs = [(train, s, f'scene_{s:02d}') for s in range(TRAIN_SCENES)]
    jobs.append((val, 7, 'scene_00'))
    t = time.time()
    with multiprocessing.get_context('spawn').Pool(len(jobs)) as pool:
        pool.starmap(_make_scene, jobs)
    log(f'data: {TRAIN_SCENES} train scenes and 1 val scene of '
        f'{SIZE}x{SIZE} in {time.time() - t:.1f} s')
    return train, val


def window_gather_bound(b: int, win: int, ci: int, with_mpi: bool):
    """Least time for K1: every selected window byte read once and written
    once, over the HBM rate (a copy has no arithmetic)."""
    from mmlf_tpu_torch.ops.kernels.window_gather import AUX_CH, MPI_CH
    ch = ci + AUX_CH + (MPI_CH if with_mpi else 0)
    n_bytes = 2 * 4 * b * win * win * ch
    return n_bytes / PEAK_BYTES * 1e3, n_bytes


def check_gather(W, cache, batch, win, what: str) -> float:
    """K1 against its plain version on ``batch``, with and without the MPI
    field: a copy, so equal bit for bit."""
    import numpy as np
    import torch
    index = np.stack([batch.scene, batch.factor - 1, batch.ws_y,
                      batch.ws_x]).astype(np.int32)
    for with_mpi in (False, True):
        got = W.window_gather(cache.img, cache.aux, cache.mpi, *index, win,
                              with_mpi=with_mpi)
        want = W.plain_window_gather(cache.img, cache.aux, cache.mpi, index,
                                     win, with_mpi)
        torch.cuda.synchronize()
        for g, w in zip(got, want):
            if (g is None) != (w is None) or \
                    (g is not None and not torch.equal(g, w)):
                raise AssertionError(f'{what}: K1 differs from its plain '
                                     f'version (with_mpi={with_mpi})')
    return 0.0


def phase_train(W, K, train: str, val: str, run: str) -> dict:
    """The README UPR recipe through the train CLI, then K1 against its
    plain version on the run's own last batch."""
    import numpy as np
    import torch
    from mmlf_tpu_torch.train import cli, loop

    # record the pipeline the run builds, to reread its last batch
    seen = {}

    class Recording(loop.DevicePipeline):
        def sample_batch(self, batch_size):
            seen['batch'] = super().sample_batch(batch_size)
            seen['pipeline'] = self
            return seen['batch']

    loop.DevicePipeline = Recording
    os.makedirs(run)
    args = [run, '--train_trainset', train, '--train_valset', val,
            *RECIPE, '--train_steps', str(TRAIN_STEPS), '--train_nan_guard']
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    W.window_gather.launches = K.laplace_mixture_posterior.launches = 0
    t = time.time()
    state = cli.main(args, standalone_mode=False)
    torch.cuda.synchronize()
    wall = time.time() - t
    launches = W.window_gather.launches
    peak = torch.cuda.max_memory_allocated()
    loop.DevicePipeline = Recording.__bases__[0]

    accum = int(RECIPE[RECIPE.index('--train_accum') + 1])
    if launches != TRAIN_STEPS * accum:
        raise AssertionError(f'K1 launched {launches} times in '
                             f'{TRAIN_STEPS} steps x {accum} microbatches')
    if state.step != TRAIN_STEPS:
        raise AssertionError(f'train stopped at step {state.step}')
    rows = [[float(v) for v in line.split(',')] for line in
            open(os.path.join(run, 'log.csv')).read().splitlines()[1:]]
    if [int(r[0]) for r in rows] != list(range(TRAIN_STEPS)) or \
            not np.isfinite(np.array(rows)).all():
        raise AssertionError(f'log.csv rows {rows}')
    ckpt = torch.load(os.path.join(run, 'checkpoint.pt'),
                      map_location='cpu', weights_only=True)
    if ckpt['iteration'] != TRAIN_STEPS or \
            ckpt['optimizer_state_dict'] is None:
        raise AssertionError('checkpoint.pt does not hold the final step')

    # K1 on the run's own last batch, microbatch by microbatch
    pipe, batch = seen['pipeline'], seen['batch']
    from mmlf_tpu_torch.data.pipeline import chunk_slice
    size = len(batch.scene) // accum
    for c in range(accum):
        check_gather(W, pipe.cache, chunk_slice(batch, c * size,
                                                (c + 1) * size),
                     pipe.win, f'train batch chunk {c}')

    bs = int(RECIPE[RECIPE.index('--train_bs') + 1])
    ps = int(RECIPE[RECIPE.index('--train_ps') + 1])
    steady = [r[5] for r in rows[1:]]
    s_step = sum(steady) / len(steady)
    flop = 3 * conv_flop_per_pixel() * ps * ps * bs
    log(f'train: {TRAIN_STEPS} steps of bs {bs} ({accum} x {size}), ps {ps}, '
        f'in {wall:.1f} s CLI wall; steady steps {steady} s, '
        f'{s_step:.3f} s/step, {bs / s_step:.1f} patches/s, '
        f'{flop / s_step / 1e12:.1f} TFLOP/s conv fwd+bwd fp32 '
        f'({flop / 1e12:.1f} TFLOP/step), peak device memory '
        f'{peak / 2**30:.2f} GiB, K1 launches {launches}, losses '
        f'{[r[1] for r in rows]}')
    return {'launches': launches, 'pipeline': pipe, 's_step': s_step,
            'size': size}


def phase_window_gather(W, pipe, size: int) -> dict:
    """K1 at the recipe shape (a fresh batch of the run's pipeline, all
    four levels present) against its plain version; times of the kernel,
    the plain version, one advanced-indexing call on a one-level batch,
    the augmentation and the host sampler."""
    import numpy as np
    import torch
    from mmlf_tpu_torch.data.pipeline import gather_augment

    cache, win, ps = pipe.cache, pipe.win, pipe.ps
    for _ in range(100):
        batch = pipe.sample_batch(size)
        if len(set(batch.factor.tolist())) == len(cache.img):
            break
    else:
        raise AssertionError('no batch with every level in 100 draws')
    err = check_gather(W, cache, batch, win, 'recipe batch')
    index = np.stack([batch.scene, batch.factor - 1, batch.ws_y,
                      batch.ws_x]).astype(np.int32)
    ci = cache.img[0].shape[-1]
    out = {}
    for with_mpi in (False, True):
        ms = cuda_ms(lambda: W.window_gather(cache.img, cache.aux, cache.mpi,
                                             *index, win, with_mpi=with_mpi),
                     reps=20)
        plain_ms = cuda_ms(lambda: W.plain_window_gather(
            cache.img, cache.aux, cache.mpi, index, win, with_mpi), reps=5)
        bound_ms, n_bytes = window_gather_bound(size, win, ci, with_mpi)
        out[with_mpi] = (ms, plain_ms, bound_ms)
        log(f'kernel window_gather B={size} win={win} CI={ci} '
            f'with_mpi={with_mpi}: {ms:.4f} ms, plain {plain_ms:.3f} ms, '
            f'bound {bound_ms:.4f} ms (bytes: {n_bytes / 1e9:.3f} GB at '
            f'{PEAK_BYTES / 1e12:.2f} TB/s), '
            f'{n_bytes / ms / 1e6:.0f} GB/s achieved')

    # one advanced-indexing call per field computes the windows when every
    # sample takes one level: time it on level 0 (no MPI, as the recipe)
    index0 = index.copy()
    index0[1] = 0
    dev = cache.img[0].device
    s_, wy, wx = (torch.from_numpy(index0[k]).long().to(dev)
                  for k in (0, 2, 3))
    ar = torch.arange(win, device=dev)
    rows, cols = (wy[:, None] + ar)[:, :, None], (wx[:, None] + ar)[:, None]
    aux0 = cache.aux[0].view(*cache.aux[0].shape[:2], -1, W.AUX_CH)

    def library():
        return (cache.img[0][s_[:, None, None], rows, cols],
                aux0[s_[:, None, None], rows, cols])

    lib_img, lib_aux = library()
    k_img, k_aux, _ = W.window_gather(cache.img, cache.aux, cache.mpi,
                                      *index0, win, with_mpi=False)
    if not (torch.equal(lib_img, k_img) and
            torch.equal(lib_aux.reshape(k_aux.shape), k_aux)):
        raise AssertionError('K1 differs from advanced indexing on level 0')
    library_ms = cuda_ms(library, reps=20)
    one_level_ms = cuda_ms(lambda: W.window_gather(
        cache.img, cache.aux, cache.mpi, *index0, win, with_mpi=False),
        reps=20)
    log(f'kernel window_gather one-level batch: {one_level_ms:.4f} ms, '
        f'advanced indexing (img + aux) {library_ms:.4f} ms')

    aug_ms = cuda_ms(lambda: gather_augment(cache, batch, ps, win,
                                            with_mpi=False), reps=10)
    t = time.perf_counter()
    for _ in range(5):
        pipe.sample_batch(size * 8)
    sampler_s = (time.perf_counter() - t) / 5
    log(f'input path per microbatch of {size}: gather + augmentation '
        f'{aug_ms:.3f} ms (K1 {out[False][0]:.4f} ms of it); host sampler '
        f'{sampler_s * 1e3:.1f} ms per batch of {size * 8}')
    ms, plain_ms, bound_ms = out[False]
    return {'max_abs_err': err, 'ms': ms, 'plain_ms': plain_ms,
            'bound_ms': bound_ms, 'bound_by': 'bytes',
            'library_ms': library_ms, 'aug_ms': aug_ms,
            'sampler_s': sampler_s}


def phase_main(K, run: str, val: str) -> dict:
    """ESE validate of the train phase's checkpoint through the CLI."""
    import numpy as np
    import torch
    from mmlf_tpu_torch.validate import cli

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    K.laplace_mixture_posterior.launches = 0
    t = time.time()
    result = cli.main([run, val, '--val_ensamble'], standalone_mode=False)
    torch.cuda.synchronize()
    wall = time.time() - t
    launches = K.laplace_mixture_posterior.launches
    peak = torch.cuda.max_memory_allocated()

    for key in ('mse', 'badpix', 'kld', 'kld_mm', 'kld_um', 'nll'):
        if not math.isfinite(result[key]):
            raise AssertionError(f'metric {key} = {result[key]}')
    if launches != 1:
        raise AssertionError(f'mixture posterior launched {launches} '
                             f'times for 1 scene')
    scene = os.path.join(run, 'scenes', 'scene_00')
    for f in ('result.pfm', 'result.png', 'uncert.pfm', 'gt.pfm',
              'center.png', 'diff.png', 'view_h_0.png', 'gmm.npy',
              'posterior.npy'):
        if not os.path.exists(os.path.join(scene, f)):
            raise AssertionError(f'artifact {f} missing')
    for f in ('ours/disp_maps/scene_00.pfm', 'ours/runtimes/scene_00.txt'):
        if not os.path.exists(os.path.join(run, f)):
            raise AssertionError(f'artifact {f} missing')
    post = np.load(os.path.join(scene, 'posterior.npy'))
    gmm = np.load(os.path.join(scene, 'gmm.npy'))
    if post.shape != (70, SIZE, SIZE) or not np.isfinite(post).all():
        raise AssertionError(f'posterior.npy {post.shape}')
    if gmm.shape != (2, 70, SIZE, SIZE) or not np.isfinite(gmm).all():
        raise AssertionError(f'gmm.npy {gmm.shape}')

    log(f'main: metrics of the {TRAIN_STEPS}-step checkpoint (the values '
        f'mean nothing) '
        + json.dumps({k: result[k] for k in ('mse', 'badpix', 'kld',
                                              'kld_mm', 'kld_um', 'nll')}))
    log(f'main: ESE validate {result["runtime"]:.3f} s/scene (CLI runtime, '
        f'load to artifacts), {wall:.3f} s CLI wall, peak device memory '
        f'{peak / 2**30:.3f} GiB, mixture posterior launches {launches}')

    # the kernel against its plain version on the main path's own members
    dev = torch.device('cuda')
    means = torch.from_numpy(gmm[0].reshape(70, -1)).to(dev)
    scales = torch.from_numpy(gmm[1].reshape(70, -1)).to(dev)
    bins = torch.from_numpy(
        np.linspace(-3.5, 3.5, 70).astype(np.float32)).to(dev)
    got = K.laplace_mixture_posterior(means, scales, bins)
    err = check_close(got, K.plain_mixture_posterior(means, scales, bins),
                      'mixture posterior vs plain (main-path members)')
    check_close(got, torch.from_numpy(post.reshape(70, -1).T).to(dev),
                'kernel vs posterior.npy of the CLI')
    log(f'main: kernel vs plain on the main path\'s members, max abs err '
        f'{err:.3e}')
    return {'launches': launches, 'max_abs_err': err,
            's_per_scene': result['runtime'], 'wall_s': wall,
            'peak_bytes': peak}


def phase_member_time() -> None:
    """Device time of one warm full-width ESE member (shift + forward) at
    512², for the breakdown of the ESE time."""
    import torch
    from mmlf_tpu_torch.config import Config
    from mmlf_tpu_torch.models.feed_forward import FeedForward, init_live_
    from mmlf_tpu_torch.ops.shift import shift_lf

    cfg = Config(val_ensamble=True, model_no_batchnorm=True).finalize()
    model = init_live_(FeedForward.from_config(cfg), seed=1).cuda().eval()
    gen = torch.Generator(device='cuda').manual_seed(0)
    stacks = [torch.rand((1, 9, SIZE, SIZE, 3), generator=gen,
                         device='cuda') for _ in range(4)]
    with torch.no_grad():
        fwd_ms = cuda_ms(lambda: model(*stacks), reps=3)
        shift_ms = cuda_ms(lambda: shift_lf(*stacks, 1.3), reps=10)
    flop = SIZE * SIZE * conv_flop_per_pixel()
    log(f'member: forward {fwd_ms:.2f} ms ({flop / fwd_ms / 1e9:.1f} '
        f'TFLOP/s fp32 on {flop / 1e12:.3f} TFLOP), shift {shift_ms:.3f} ms; '
        f'x70 members = {70 * (fwd_ms + shift_ms) / 1e3:.2f} s')


def phase_breakdown(run: str, val: str) -> None:
    """Host-clock times of the validate path's pieces outside the member
    forwards, on the main path's scene and member dumps."""
    import numpy as np
    import torch
    from mmlf_tpu_torch.data.hci4d import HCI4D
    from mmlf_tpu_torch.models.ensemble import ensemble_grid
    from mmlf_tpu_torch.ops.masks import create_mask_margin
    from mmlf_tpu_torch.ops.masks import create_mask_texture
    from mmlf_tpu_torch.validate import calibrate
    from mmlf_tpu_torch.validate import posteriors as P

    def timed(fn):
        torch.cuda.synchronize()
        t = time.time()
        out = fn()
        torch.cuda.synchronize()
        return out, time.time() - t

    data = HCI4D(val)
    sample, t_load = timed(lambda: data[0])
    _, t_tex = timed(lambda: create_mask_texture(sample[4]))
    gmm = np.load(os.path.join(run, 'scenes', 'scene_00', 'gmm.npy'))
    means, logvars = gmm[0], np.log(gmm[1])            # (K, H, W)
    mask = create_mask_margin(sample[5].shape, 15).numpy()
    _, t_cal = timed(lambda: calibrate.scene_calibration(
        ensemble_grid(-3.5, 3.5, 0.1), means, logvars, sample[5], mask))
    dm = torch.from_numpy(means).cuda()
    dv = torch.from_numpy(gmm[1]).cuda()
    _, t_lmm = timed(lambda: P.lmm_to_discrete(108, -3.5, 3.5, dm,
                                               torch.exp(dv)))
    _, t_d2h = timed(lambda: (dm.cpu(), dv.cpu()))
    log(f'breakdown (host clock): scene load {t_load:.3f} s (texture mask '
        f'{t_tex:.3f} s of it), calibration guard {t_cal:.3f} s, ESE KLD '
        f'discretization {t_lmm:.3f} s, member dumps to host '
        f'{t_d2h:.3f} s')


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print('chip_smoke: CUDA is not available', file=sys.stderr)
        return 2
    sys.path.insert(0, REPO)
    try:
        from mmlf_tpu_torch.ops.kernels import build
        from mmlf_tpu_torch.ops.kernels import posterior as K
        from mmlf_tpu_torch.ops.kernels import window_gather as W
    except ImportError as e:
        print(f'chip_smoke: the port is not beside this script ({e})',
              file=sys.stderr)
        return 2

    card = smi('name,power.limit')
    log(f'card: {card}; torch {torch.__version__}, CUDA '
        f'{torch.version.cuda}, {torch.cuda.device_count()} device(s)')

    t = time.time()
    libs = build.build_all()
    log(f'build: {len(libs)} kernel(s) in {time.time() - t:.1f} s: '
        + ', '.join(os.path.relpath(str(p), REPO) for p in libs.values()))
    for name in libs:
        report = build.ptxas_report(name)
        regs = [int(w) for w in re.findall(r'Used (\d+) registers', report)]
        spills = [int(w) for w in re.findall(r'(\d+) bytes spill stores',
                                             report)]
        log(f'build: {name}: {len(regs)} kernel instantiation(s), '
            f'{min(regs)}-{max(regs)} registers, spill stores up to '
            f'{max(spills)} bytes')

    work = os.path.join(REPO, 'build', 'chip_smoke')
    shutil.rmtree(work, ignore_errors=True)
    train, val = phase_data(work)
    run = os.path.join(work, 'run')
    train_run = phase_train(W, K, train, val, run)
    gather = phase_window_gather(W, train_run['pipeline'], train_run['size'])
    s_step, k1_launches = train_run['s_step'], train_run['launches']
    per_step = k1_launches / TRAIN_STEPS
    log(f'train step shares: K1 {per_step * gather["ms"] / 1e3 / s_step:.2%}'
        f', gather + augmentation '
        f'{per_step * gather["aug_ms"] / 1e3 / s_step:.2%}, host sampler '
        f'{gather["sampler_s"] / s_step:.2%} of {s_step:.3f} s/step')
    del train_run
    torch.cuda.empty_cache()

    main_run = phase_main(K, run, val)
    kern = phase_kernel(K)
    phase_member_time()
    phase_breakdown(run, val)
    torch.cuda.synchronize()

    kernels = [{
        'name': 'window_gather',
        'route': 'cuda',
        'source': 'mmlf_tpu_torch/csrc/window_gather.cu',
        'replaces': 'mmlf_tpu/ops/pallas/window_gather.py:94',
        'launches': k1_launches,
        'max_abs_err': gather['max_abs_err'],
        'ms': gather['ms'],
        'plain_ms': gather['plain_ms'],
        'bound_ms': gather['bound_ms'],
        'bound_by': gather['bound_by'],
        'library_ms': gather['library_ms'],
    }, {
        'name': 'laplace_mixture_posterior',
        'route': 'cuda',
        'source': 'mmlf_tpu_torch/csrc/posterior.cu',
        'replaces': 'mmlf_tpu/ops/pallas/posterior.py:48',
        'launches': main_run['launches'],
        'max_abs_err': max(kern['max_abs_err'], main_run['max_abs_err']),
        'ms': kern['ms'],
        'plain_ms': kern['plain_ms'],
        'bound_ms': kern['bound_ms'],
        'bound_by': kern['bound_by'],
        'library_ms': None,          # no single PyTorch call computes it
    }]
    print(json.dumps({'kernels': kernels}))
    print(card)
    print(json.dumps({'ok': True, 'device': {
        'platform': 'gpu', 'kind': torch.cuda.get_device_name(0),
        'count': torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == '__main__':
    sys.exit(main())
