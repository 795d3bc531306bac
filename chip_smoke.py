#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one CUDA card.

    python3 chip_smoke.py

Phases, in order; any failure exits non-zero and prints no result:

1. card    — the card's name and power limit (nvidia-smi);
2. build   — every CUDA kernel of mmlf_tpu_torch/csrc, one nvcc each,
             started together;
3. kernel  — each kernel against its plain PyTorch version at the main
             path's shape, on seeded inputs, with its time, the plain
             version's time and the bound;
4. main    — ESE validation end to end through the validate CLI: one 512²
             synthetic scene (seed 0), a full-width UPR checkpoint (chs 70,
             3+8 blocks, 9 views) with random seeded weights, 70 members;
             checks the metrics, the artifact tree and that every kernel of
             the path launched; then holds the kernel against its plain
             version on the main path's own member stacks;
5. the kernels line (JSON), the card line, and the last line
   ``{"ok": true, "device": {...}}``.

The weights are random, so the accuracy numbers printed mean nothing; the
run shows that the port builds, agrees with its plain versions and runs the
path on the card.  Imports nothing of JAX or of mmlf_tpu.
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


def phase_main(K, work: str) -> dict:
    """ESE validate end to end through the CLI on one 512² scene."""
    import numpy as np
    import torch
    from mmlf_tpu_torch.config import Config
    from mmlf_tpu_torch.data.synth import generate_dataset
    from mmlf_tpu_torch.models.feed_forward import FeedForward, init_live_
    from mmlf_tpu_torch.utils.convert import save_checkpoint_pt
    from mmlf_tpu_torch.validate import cli

    data, run = os.path.join(work, 'data'), os.path.join(work, 'run')
    t = time.time()
    generate_dataset(data, scenes=1, size=SIZE, seed=0)
    cfg = Config(val_ensamble=True).finalize()      # full width UPR
    model = init_live_(FeedForward.from_config(cfg), seed=0)
    os.makedirs(run)
    save_checkpoint_pt(os.path.join(run, 'checkpoint.pt'),
                       model.state_dict(), cfg)
    n_params = sum(p.numel() for p in model.parameters())
    log(f'main: scene {SIZE}x{SIZE} and checkpoint (chs {cfg.model_chs}, '
        f'{cfg.model_in_blocks}+{cfg.model_out_blocks} blocks, '
        f'{n_params} params) written in {time.time() - t:.1f} s')

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    K.laplace_mixture_posterior.launches = 0
    t = time.time()
    result = cli.main([run, data, '--val_ensamble'], standalone_mode=False)
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

    log(f'main: metrics (random weights: the values mean nothing) '
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
    flop = SIZE * SIZE * (4 * (2 * 4 * 27 * 70 + 5 * 2 * 4 * 70 * 70)
                          + 7 * 2 * 2 * 4 * 280 * 280)
    log(f'member: forward {fwd_ms:.2f} ms ({flop / fwd_ms / 1e9:.1f} '
        f'TFLOP/s fp32 on {flop / 1e12:.3f} TFLOP), shift {shift_ms:.3f} ms; '
        f'x70 members = {70 * (fwd_ms + shift_ms) / 1e3:.2f} s')


def phase_breakdown(work: str) -> None:
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

    data = HCI4D(os.path.join(work, 'data'))
    sample, t_load = timed(lambda: data[0])
    _, t_tex = timed(lambda: create_mask_texture(sample[4]))
    gmm = np.load(os.path.join(work, 'run', 'scenes', 'scene_00',
                               'gmm.npy'))
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

    kern = phase_kernel(K)

    work = os.path.join(REPO, 'build', 'chip_smoke')
    shutil.rmtree(work, ignore_errors=True)
    main_run = phase_main(K, work)
    phase_member_time()
    phase_breakdown(work)
    torch.cuda.synchronize()

    kernels = [{
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
