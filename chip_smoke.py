#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one CUDA card.

    python3 chip_smoke.py          # every phase, as below
    python3 chip_smoke.py k3       # card, build and the K3 phase only
    python3 chip_smoke.py k2       # card, build and the K2 phase only
    python3 chip_smoke.py serve    # card, build, the val scene, a seeded
                                   # full-width checkpoint, main and serve
    python3 chip_smoke.py bf16     # card, build, data and the bf16 phases
                                   # (7b-7e, 10b)
    python3 chip_smoke.py bf16_trunk  # card, build, data and
                                   # train_bf16_trunk (7d) only
    python3 chip_smoke.py host     # card, build, data, host, train_host
    python3 chip_smoke.py unet     # card, build, data and unet
    python3 chip_smoke.py dp       # card, build, data and dp
    python3 chip_smoke.py probes   # card, build and probes
    python3 chip_smoke.py dp4      # four cards: card, build, data and dp
                                   # on 4 NCCL ranks, one a card, through
                                   # the CLI's own --mesh_data path
    python3 chip_smoke.py k1       # card, build, data and phase K1 twice
                                   # on the recipe's device cache (no
                                   # train run)
    python3 chip_smoke.py mesh_val # card, build, the val scene, a seeded
                                   # full-width checkpoint, main and
                                   # mesh_val
    python3 chip_smoke.py inn      # card, build, data and inn
    python3 chip_smoke.py analysis # card, build, the val scene, a seeded
                                   # full-width checkpoint, main and
                                   # analysis

Phases, in order; any failure exits non-zero and prints no result:

1. card    — the card's name and power limit (nvidia-smi);
2. build   — every CUDA kernel of mmlf_tpu_torch/csrc, one nvcc each,
             started together, with each kernel's ptxas report (and the
             registers and spill bytes of each bf16 conv2x2_kernel and
             wgrad_kernel instance);
3. data    — 4 synthetic 512² train scenes (seeds 0-3) and one val scene
             (seed 7), one process each;
3b. host   — the port's host library (csrc_host/mmlf_native.cpp) built by
             g++ into build/host and loaded (a failed build raises); the val
             scene's texture mask, native against the numpy fallback
             (equal), both timed; strided_window against numpy slicing at
             f = 1..4 (equal); the host sampler's ms per batch of 512 at
             the recipe with 4 and with 0 worker threads, and the batch's
             copy to the card from pinned memory;
4. train   — the README UPR recipe through the train CLI at full width
             (chs 70, 3+8 blocks, 9 views): bs 512 as 8 microbatches of
             64, ps 96, train_shift 2.5, warm-start LR 1e-3, TRAIN_STEPS
             steps, validation at step 0; checks the log rows, the
             checkpoint (its iteration the last save's) and that kernel K1
             launched steps × accum times, then holds K1 against its plain
             version on the run's own last batch; prints s/step,
             patches/s, conv TFLOP/s, peak memory and the time each
             rolling-checkpoint save blocked the step loop (the snapshot;
             the write runs on the saver's thread);
5. K1      — the window gather against its plain version at the recipe
             shape (64 windows of 128², all four levels, with and without
             the MPI field), its time, the plain version's, one
             advanced-indexing call's, and the bound; the augmentation's
             and the host sampler's time;
6. train_trunk — the same recipe with ``--pallas_trunk`` (every
             train-mode conv block through kernel K3) for TRUNK_STEPS
             steps; checks the log rows, the checkpoint and that K3
             forward and backward each launched 20 × accum × steps times
             (and K1 accum × steps); prints the same numbers as train;
7. K3      — the fused double-conv block's error against a float64
             evaluation on real-valued inputs (280→280, recipe and ragged
             sizes) within 4x the fp32 plain version's; forward and
             backward against their plain versions at the recipe's block
             shapes (B 64, 96²: 27→70, 70→70, 280→280, 280→2, and the DPP
             head's 280→108), their times, the plain versions', the bound
             (3xTF32 on the tensor cores; the FFMA bound as context) and,
             as context, the port's plain ConvBlock (cuDNN) forward and
             backward; a profile of the 280→280 block by CUDA kernel, the
             backward split into its conv GEMMs and weight gradients;
7b. train_bf16 — the recipe with ``--bf16 --cache_bf16`` (a bf16 trunk on
             cuDNN's bf16 convs, K1 cutting bf16 image windows) for
             TRAIN_STEPS steps, checked as train (K1's bf16 instance
             launched steps × accum times);
7c. K1 bf16 — phase K1 on the bf16 cache of train_bf16;
7d. train_bf16_trunk — the same with ``--pallas_trunk``: K3's bf16
             instance forward and backward 20 × accum × steps times each;
7e. K3 bf16 — K3's bf16 instance against its plain version evaluated in
             float64 (the same rounding points) on dyadic inputs at the
             recipe's blocks, each output within 4x the float32 plain
             version's error (fp32 convs, TF32 off, on bf16-rounded
             operands; ``k3_bf16_check``); times, the bound at the dense
             bf16 tensor-core peak and cuDNN's bf16 ConvBlock as context,
             and the 280→280 profile and backward split as in K3; then
             the backward of 27→70, 70→70 and 280→280 at two ragged
             shapes (stages that cross images, odd image sizes, a last
             stage past the end), every output held the same way;
7f. train_host — the recipe with ``--host_pipeline --bf16 --pallas_trunk``
             for TRAIN_STEPS steps: the windows cut on the host, copied to
             the card and augmented there; checks the log rows, the
             checkpoint, K3's bf16 instance 20 × accum × steps times each
             way and K1 none, and that the run's first host batch equals
             the one the same seed gives with native code disabled; prints
             s/step, the sampler's and the copy's ms per batch and peak
             memory;
7g. unet   — the recipe with ``--model_unet`` (fp32) for UNET_STEPS steps,
             K1 accum × steps times; ESE validation of its checkpoint
             (whole scene, K2 once); one exported UPR artifact served over
             HTTP, its mean within SERVE_TOL of the direct eval forward's;
             prints s/step, s/scene, runtime_s and peak memory;
7h. dp     — the recipe with ``--pallas_trunk --mesh_data 2`` through the
             library API (``train_ranks``) for DP_STEPS steps on two gloo
             ranks that share the card (NCCL refuses two ranks on one
             device), full width; each rank reports the launches it counted
             (K1 and K3 on its half of every microbatch); then the same on
             one rank from the same seed: losses within DP_LOSS_REL, BN
             running statistics within DP_STATS_REL; s/step printed, but it
             is no scaling number (both ranks share one card);
7i. probes — the probe scripts' kernels (``mmlf_tpu_torch/probes``): the
             fused block's check (fp32, K3's fused-block configuration) and
             one block against float64, the bench (bf16, B 64, 96², C 280
             and 256, 7 blocks) with its first blocks as ``k3_bf16_check``,
             and the window copies of probe3 and probe4 (the row copy and
             the two-slot ring), bit for bit against advanced indexing;
             times, plain versions', bounds and the library calls';
7j. inn    — ``--model_inn`` at full width (9 views, 3 + 8 coupling
             blocks, ksize 2, dims 108): the recipe's batch flags without
             ``--model_uncert`` for INN_STEPS steps (K1 accum x steps, no
             K3), checked as train; its checkpoint validated whole-scene and
             with ``--val_tile 64`` (windows of 108, ``mu``'s side), the
             stitched outputs against the whole scene's; exported and
             served over HTTP, the mean against the direct forward
             (SERVE_TOL); prints s/step, patches/s, peak memory, s/scene
             and runtime_s, and a profile of one microbatch split into
             convolutions and the rest;
8. main    — ESE validation of the train phase's checkpoint through the
             validate CLI on the val scene, 70 members; checks the
             metrics, the artifacts and that K2 launched once; then holds
             K2 against its plain version on the run's own members;
8b. analysis — the analysis CLIs through their ``main`` on phase main's
             output (70 members, 70 bins): sparsify, cluster, modecnt,
             multimodal --uni / --multi / --lb, mm_prediction, gmm_cnt on
             the card at its default grid (1400 points x 70 members x
             512² pixels), gmm2csv and post2csv at one pixel, uncert2csv,
             edges on the val dataset; checks their files, prints each
             CLI's wall time and gmm_cnt's device time (CUDA events), then
             holds ``count_modes`` on the card against its CPU path on one
             chunk of 8192 pixels: the density within ANALYSIS_RTOL, the
             maps equal but at pixels with a near tie (two neighbouring
             grid values within ANALYSIS_TIE_REL in float64), whose share
             it prints; no plot (the card's machine has no matplotlib);
9. main_tiled — the same validation with ``--val_tile 256`` (4 windows of
             310², halo 27); checks that K2 launched once per tile and
             holds the member means and logvars and the selected member
             against phase main's; prints s/scene, peak memory and the
             metrics' differences from phase main's;
9b. mesh_val — the same checkpoint with ``--val_ensamble --mesh_ensemble
             2`` and ``--val_ensamble --mesh_space 2`` through the library
             entry (``run_validation_ranks``) on two gloo ranks sharing
             the card: K2 once per scene on each rank (none in this
             process); members, posterior, result and metrics against
             phase main's (MESH_TOL, MESH_REL); s/scene, which is no
             scaling number;
10. serve  — the plain run's checkpoint exported as five artifacts (UPR
             fp32, UPR u8, UPR batch 2, UPR tiled 256, ESE), each served
             by ``make_server`` on a thread and sent one warm-up and 3 (ESE:
             2) timed requests over HTTP; checks /healthz, status 200, the
             u8, batch-2 and tiled means against the fp32 one (1e-5), the
             ESE result.pfm and metrics against phase main's, and K2 once
             per ESE request; prints median runtime_s, HTTP wall, host
             share and peak memory for each;
10b. bf16_eval — ESE validation of train_bf16_trunk's checkpoint (the bf16
             trunk on BN-folded weights, K2 once), its member means
             against the same weights in fp32 (BF16_MEMBER_PX), and one
             UPR request to its exported artifact over HTTP;
11. K2     — the mixture posterior at the whole scene's P = 512² and one
             tile's P = 310² (K = Kb = 70), and at 512² with
             ``--val_disp_step 0.05``'s K = Kb = 141: within TOL of its
             plain version, and its error against a float64 evaluation
             within 4x the fp32 plain version's; its time, the plain
             version's and its bounds (operations, the exp units alone,
             and the exp units and the fp32 pipe balanced), and the
             registers and spills of each of its instances;
12. member / breakdown — device time of one ESE member and host times of
             the validate path's other pieces;
13. the kernels line (JSON), the card line, and the last line
   ``{"ok": true, "device": {...}}``.

The weights start random (seeded) and train a few steps, so the accuracy
numbers printed mean nothing; the run shows that the port builds, agrees
with its plain versions and runs the main path's train step (plain and
``--pallas_trunk``, each in float32 and in bfloat16), its validation and
its serving on the card, data parallel over two ranks, sharded
validation over two ranks, the INN end to end, the probe scripts'
kernels, and the analysis CLIs on the validation's output.
Imports nothing of JAX or of mmlf_tpu.
"""

from __future__ import annotations

import gc
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
TRAIN_STEPS = 3
TRUNK_STEPS = 3
# steps of phase unet (the recipe with --model_unet)
UNET_STEPS = 3
# the recipe's trunk blocks per microbatch: 4 streams x 3 blocks + 8 out_net
TRUNK_BLOCKS = 4 * 3 + 8
# the README UPR recipe (bs 512 as 8 microbatches of 64)
RECIPE = ['--train_shift', '2.5', '--train_lr', '1e-3', '--train_bs', '512',
          '--train_ps', '96', '--train_warm_start', '--model_uncert',
          '--train_accum', '8']
# H100 SXM peaks (NVIDIA data sheet, dense): HBM bytes/s, fp32 FLOP/s
# outside the tensor cores, TF32 and bf16 FLOP/s of the tensor cores
PEAK_BYTES = 3.35e12
PEAK_FP32 = 67e12
PEAK_TF32 = 495e12
PEAK_BF16 = 989e12
# an fp32-accurate product in 3xTF32 (hi*hi' + hi*lo' + lo*hi') costs three
# TF32 products: the least time of K3's GEMMs on this card
PEAK_3XTF32 = PEAK_TF32 / 3
SFU_PER_SM_CLK = 16          # MUFU.EX2 results per SM per clock (Hopper)
# fp32 instructions per warp and clock over MUFU.EX2 results (128 / 16)
FP32_PER_EX2 = 8
# ex2.approx / the polynomial exp2 on a pre-scaled argument
TOL = dict(rtol=1e-4, atol=1e-6)
# K2's error against a float64 evaluation stays within this factor of the
# fp32 plain version's (exp and a division per term)
K2_PREC_FACTOR = 4.0
# the validate CLI's metrics
METRICS = ('mse', 'badpix', 'kld', 'kld_mm', 'kld_um', 'nll')
# a bf16 checkpoint's ESE member means against the same weights run in
# fp32: the largest difference, in pixels of disparity, below the BadPix
# threshold of 0.07 (each of the ~22 bf16 convs and BN affines rounds at
# 2^-9 relative; a loose sanity bound, not a parity test)
BF16_MEMBER_PX = 0.05
# --val_tile of phase main_tiled, and its halo: the trunk's receptive
# radius 2 * (3 + 8) plus the ensemble's ceil(3.5) + 1
VAL_TILE = 256
VAL_HALO = 22 + 5
VAL_WINDOW = VAL_TILE + 2 * VAL_HALO
# phase serve: the artifacts exported from the plain train phase's
# checkpoint, in this order (u8, batch-2 and tiled are held against 'upr')
SERVE_ARTIFACTS = (('upr', {}), ('upr_u8', {'u8': True}),
                   ('upr_b2', {'batch': 2}),
                   ('upr_tiled', {'tiled': VAL_TILE}),
                   ('ese', {'val_ensamble': True}))
# the UPR requests' train_shift (the u8 artifact shifts on the device); the
# ESE requests carry none, so the server's 0.0 applies, the shift phase
# main validated at (its CLI default 0.0 overrides the stored 2.5)
SERVE_SHIFT = 2.5
# timed requests after one warm-up, by val_ensamble
SERVE_REQUESTS = {False: 3, True: 2}
# the same function on the same card: max abs difference of served means
# (u8 vs fp32: the same values by another route; batch 2 and tiled: other
# conv shapes), and the ESE metrics' relative difference from phase main
SERVE_TOL = 1e-5
SERVE_REL = 1e-5
# K2's (members = bins, pixels): the ESE's 70 at the whole 512² scene and
# at one 310² window, and --val_disp_step 0.05's 141 (16 bins a thread, two
# passes) at 512²
K2_CASES = ((70, SIZE * SIZE), (70, VAL_WINDOW * VAL_WINDOW),
            (141, SIZE * SIZE))
# tiled ESE equals the whole-scene ESE at least this far from the image
# border: a window's view shifts wrap around its own edge where the whole
# scene's wrap around the scene's, and reach 4 x 3.5 = 14 px (views 0..8
# around 4) plus the trunk's one-sided reach of 1 px per block (11)
TILED_EXACT_MARGIN = 14 + 11
# K3 against its plain version (cuDNN, TF32 off) on dyadic inputs, where the
# ReLU masks agree bit for bit: K3's products are 3xTF32 (fp32-accurate
# split products on the tensor cores) summed in another order than cuDNN's
# fp32 FFMA (K = 4 Cin terms per output, up to 590k pixels per BN sum and
# weight gradient), each output within this fraction of its largest
# magnitude
K3_REL = 1e-4
# on real-valued inputs (every operand inexact in TF32) each K3 output's
# error against a float64 evaluation stays within this factor of the fp32
# plain version's: 3xTF32 keeps fp32's accuracy, one TF32 product would be
# ~500x off
K3_PREC_FACTOR = 4.0
# the recipe's K3 block shapes (Cin, Cout, relu_in, affine_in) and their
# launches per microbatch; 280->108 is the DPP head (not in the UPR recipe)
K3_BLOCKS = [((27, 70, False, False), 4), ((70, 70, True, True), 8),
             ((280, 280, True, True), 7), ((280, 2, True, True), 1),
             ((280, 108, True, True), 0)]
# ragged (B, H, W) of K3's bf16 backward check (k3_bf16_ragged)
K3_RAGGED = [(3, 13, 17), (3, 12, 14)]
# timed calls of each chain of the fused-block probe's bench (phase probes)
PROBE_REPS = 5
# phase dp: ranks sharing the card, steps, and the tolerances of the ranks'
# losses and BN running statistics against one rank's
# (tests/test_torch_parallel.py's)
DP_RANKS = 2
DP_STEPS = 2
DP_LOSS_REL = 1e-5
DP_STATS_REL = 1e-4
# phase mesh_val: gloo ranks sharing the card, and the tolerances of the
# members (max |d| in disparity and in log units), the posterior and the
# metrics (relative) against the whole-scene run
MESH_RANKS = 2
MESH_TOL = 1e-4
MESH_REL = 1e-4
# phase inn: steps, the --val_tile whose window (64 + 2 x 22) is mu's
# side, and the tiled posterior's and logvar's max |d| from the whole scene
INN_STEPS = 3
INN_TILE = 64
INN_TILE_TOL = 1e-4
# phase analysis: gmm_cnt's card path against its CPU path on one chunk of
# pixels (the middle rows of the scene); the densities within rtol (atol:
# the largest term whose exponential is denormal, where the two exps may
# part), the maps equal but at pixels with a near tie, two neighbouring
# grid values within ANALYSIS_TIE_REL of each other in float64
ANALYSIS_CHUNK = 8192
ANALYSIS_RTOL = 1e-5
ANALYSIS_TIE_REL = 1e-5
ANALYSIS_PIXEL = ('256', '256')


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


def inn_flop_per_pixel() -> int:
    """Forward FLOP per pixel of the full-width INN (9 views, 3 + 8
    coupling blocks, ksize 2, dims 108): each block's two subnets (a 2x2
    conv from one half of the channels to twice the other half, then a
    2x2 conv at that width) and its channel permutation, 4 streams x 3
    blocks at 27 channels and 8 blocks at 108, then the readout's 108 x
    108 distance product."""
    def block(c):
        a, b = c // 2, c - c // 2
        return (2 * 4 * (a * 2 * b + (2 * b) ** 2 + b * 2 * a + (2 * a) ** 2)
                + 2 * c * c)
    return 4 * 3 * block(27) + 8 * block(108) + 2 * 108 * 108


def counters(M) -> dict:
    """Every kernel instance of the port, by name: ``(wrapper, count
    attribute)``, from the port's registry (``ops/kernels.COUNTERS``;
    float32 instances count in ``.launches``, bfloat16 ones in
    ``.launches_bf16``)."""
    return M.counters()


def reset_launches(M) -> None:
    for fn, attr in counters(M).values():
        setattr(fn, attr, 0)


def read_launches(M) -> dict:
    return {name: getattr(fn, attr) for name, (fn, attr)
            in counters(M).items()}


def expected(M, **launches) -> dict:
    """The counts of ``read_launches`` with ``launches`` and every other
    instance at 0."""
    want = dict.fromkeys(counters(M), 0)
    want.update(launches)
    return want


def check_close(got, want, what: str) -> float:
    import torch
    err = float((got - want).abs().max())
    torch.testing.assert_close(got, want, **TOL, msg=lambda m: f'{what}: {m}')
    return err


def k2_inputs(k: int, p: int, seed: int):
    """Seeded K2 inputs on the card at K = Kb = ``k``: locations over the
    disparity range, scales exp(logvar) for logvar in [-3, 1]."""
    import numpy as np
    import torch
    rng = np.random.default_rng(seed)
    dev = torch.device('cuda')
    means = torch.from_numpy(
        rng.uniform(-3.5, 3.5, (k, p)).astype(np.float32)).to(dev)
    scales = torch.exp(torch.from_numpy(
        rng.uniform(-3.0, 1.0, (k, p)).astype(np.float32)).to(dev))
    bins = torch.from_numpy(
        np.linspace(-3.5, 3.5, k).astype(np.float32)).to(dev)
    return means, scales, bins


def k2_references(K, means, scales, bins):
    """The fp32 plain version's output, and a float64 evaluation."""
    return (K.plain_mixture_posterior(means, scales, bins),
            K.plain_mixture_posterior(means.double(), scales.double(),
                                      bins.double()))


def k2_float64_errors(got, plain, ref):
    """``(got's and the fp32 plain version's max abs error against the
    float64 evaluation ``ref``, one fp32 ulp of its largest output)``."""
    return (float((got.double() - ref).abs().max()),
            float((plain.double() - ref).abs().max()),
            2.0 ** -24 * float(ref.abs().max()))


def posterior_exp_bounds(k: int, p: int, kb: int) -> dict:
    """K2's bounds from the card's pipes, besides the operation count
    (``posterior_bound``): every exponential on MUFU.EX2 (16 a clock per
    SM at the card's maximum SM clock), and MUFU.EX2 balanced against a
    pipe that takes a share f of the exponentials as a polynomial:
    ``(1 - f) * 8 = b + 9 f`` with b instructions per term besides the
    exponential.  b = 3 counts the fp32 pipe (sub, mul, fma), b = 2 an
    argument folded into one FFMA, b = 4 the issue slots (one instruction a
    clock per scheduler: sub, mul, ex2, fma; a polynomial term takes 9
    more)."""
    import torch
    props = torch.cuda.get_device_properties(0)
    clock_mhz = float(smi('clocks.max.sm').split()[0])
    exp_ms = k * kb * p / (props.multi_processor_count * SFU_PER_SM_CLK
                           * clock_mhz * 1e6) * 1e3
    out = {'exp_ms': exp_ms, 'n_sm': props.multi_processor_count,
           'clock_mhz': clock_mhz}
    for name, b in (('fp32', 3), ('folded', 2), ('issue', 4)):
        f = (FP32_PER_EX2 - b) / (FP32_PER_EX2 + 9)
        out[name] = ((1.0 - f) * exp_ms, f)
    return out


def k2_instances(report: str) -> str:
    """Registers and spill-store bytes of each of K2's instances (one per
    bins-per-thread count) in its ptxas -v report."""
    rows = []
    for entry in report.split('Compiling entry function')[1:]:
        bpt = re.search(r'mixture_posterior_kernelILi(\d+)E', entry)
        regs = re.search(r'Used (\d+) registers', entry)
        spill = re.search(r'(\d+) bytes spill stores', entry)
        if bpt and regs and spill:
            rows.append((int(bpt.group(1)), regs.group(1), spill.group(1)))
    return ', '.join(f'BPT {b}: {r} regs / {sp} B spilled'
                     for b, r, sp in sorted(rows))


def phase_kernel(K) -> dict:
    """K2 at each of K2_CASES: within TOL of its plain version, its error
    against float64 within K2_PREC_FACTOR x the fp32 plain version's;
    times and bounds.  Returns ``{(K, P): result}``."""
    res = {}
    for k, p in K2_CASES:
        means, scales, bins = k2_inputs(k, p, seed=(k + p) % 1000)
        kb = k
        got = K.laplace_mixture_posterior(means, scales, bins)
        plain, ref = k2_references(K, means, scales, bins)
        err = check_close(got, plain,
                          f'mixture posterior vs plain (K={k}, P={p})')
        e_k, e_p, floor = k2_float64_errors(got, plain, ref)
        if e_k > K2_PREC_FACTOR * max(e_p, floor):
            raise AssertionError(
                f'mixture posterior K={k}, P={p}: error vs float64 {e_k:.3e} > '
                f'{K2_PREC_FACTOR} x the fp32 plain version\'s {e_p:.3e}')
        ms = cuda_ms(lambda: K.laplace_mixture_posterior(means, scales, bins),
                     reps=20)
        plain_ms = cuda_ms(lambda: K.plain_mixture_posterior(means, scales,
                                                             bins), reps=3)
        bound_ms, bound_by = posterior_bound(k, p, kb)
        eb = posterior_exp_bounds(k, p, kb)
        log(f'kernel laplace_mixture_posterior K={k} P={p} Kb={kb}: '
            f'{ms:.4f} ms, plain {plain_ms:.3f} ms; bounds: {bound_ms:.4f} ms '
            f'({bound_by}, an exp as one fp32 op), exp units alone '
            f'{eb["exp_ms"]:.4f} ms ({eb["n_sm"]} SMs at '
            f'{eb["clock_mhz"]:.0f} MHz), exp units and fp32 pipe balanced '
            f'{eb["fp32"][0]:.4f} ms (f = {eb["fp32"][1]:.3f}; folded '
            f'argument {eb["folded"][0]:.4f} ms), issue-slot estimate '
            f'{eb["issue"][0]:.4f} ms (f = {eb["issue"][1]:.3f}); max abs err '
            f'vs plain {err:.3e} (rtol {TOL["rtol"]}, atol {TOL["atol"]}); '
            f'vs float64 {e_k:.3e}, fp32 plain {e_p:.3e} '
            f'({e_k / e_p:.2f}x, limit {K2_PREC_FACTOR}x)')
        res[(k, p)] = {'max_abs_err': err, 'ms': ms, 'plain_ms': plain_ms,
                  'bound_ms': bound_ms, 'bound_by': bound_by}
        del means, scales, bins, got, plain, ref
    return res


def _make_scene(root: str, seed: int, name: str) -> None:
    """One synthetic 512² scene, ``generate_dataset(seed=seed)``'s only
    scene, written as ``root/name`` (a worker process)."""
    sys.path.insert(0, REPO)
    from mmlf_tpu_torch.data.synth import generate_dataset
    tmp = os.path.join(root, f'.{name}')
    generate_dataset(tmp, scenes=1, size=SIZE, seed=seed)
    os.replace(os.path.join(tmp, 'scene_00'), os.path.join(root, name))
    os.rmdir(tmp)


def phase_data(work: str, n_train: int = TRAIN_SCENES):
    """``n_train`` train scenes (seeds 0, 1, ...) and the val scene (seed
    7), one process each."""
    import multiprocessing
    train, val = os.path.join(work, 'train'), os.path.join(work, 'val')
    os.makedirs(train)
    os.makedirs(val)
    jobs = [(train, s, f'scene_{s:02d}') for s in range(n_train)]
    jobs.append((val, 7, 'scene_00'))
    t = time.time()
    with multiprocessing.get_context('spawn').Pool(len(jobs)) as pool:
        pool.starmap(_make_scene, jobs)
    log(f'data: {n_train} train scenes and 1 val scene of '
        f'{SIZE}x{SIZE} in {time.time() - t:.1f} s')
    return train, val


def window_gather_bound(b: int, win: int, ci: int, with_mpi: bool,
                        img_bytes: int = 4):
    """Least time for K1: every selected window byte read once and written
    once, over the HBM rate (a copy has no arithmetic); the image field has
    ``img_bytes`` an element (2 under --cache_bf16), aux and mpi 4."""
    from mmlf_tpu_torch.ops.kernels.window_gather import AUX_CH, MPI_CH
    per_pixel = img_bytes * ci + 4 * (AUX_CH + (MPI_CH if with_mpi else 0))
    n_bytes = 2 * b * win * win * per_pixel
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


def phase_train(M, train: str, val: str, run: str, steps: int,
                trunk: bool = False, bf16: bool = False, host: bool = False,
                unet: bool = False, inn: bool = False) -> dict:
    """The README UPR recipe through the train CLI (with ``--pallas_trunk``
    when ``trunk``; with ``--bf16 --cache_bf16`` when ``bf16``: a bf16
    trunk, through K3's bf16 instance under ``trunk``, and K1 cutting bf16
    image windows; ``host``: ``--host_pipeline`` instead of
    ``--cache_bf16``, the windows cut on the host and K1 never launched;
    ``unet``: ``--model_unet``; ``inn``: ``--model_inn`` in place of
    ``--model_uncert``), then K1 against its plain version on the run's
    own last batch (the device cache's runs).  ``M`` holds the kernel
    modules."""
    import numpy as np
    import torch
    from mmlf_tpu_torch.train import cli, loop

    # record the pipeline the run builds (its batches, the host sampler's
    # and the copy's host-clock seconds)
    seen = {'sample_s': [], 'copy_s': []}
    base = loop.TrainPipeline if host else loop.DevicePipeline

    class Recording(base):
        def sample_batch(self, *a, **kw):
            t0 = time.perf_counter()
            batch = super().sample_batch(*a, **kw)
            seen['sample_s'].append(time.perf_counter() - t0)
            seen.setdefault('first', batch)
            seen['batch'], seen['pipeline'] = batch, self
            return batch

    to_device = loop.batch_to_device

    def timed_to_device(*a, **kw):
        t0 = time.perf_counter()
        out = to_device(*a, **kw)
        torch.cuda.synchronize()
        seen['copy_s'].append(time.perf_counter() - t0)
        return out

    # the rolling checkpoint: the time each save blocks the step loop (the
    # snapshot; the write runs on the saver's thread) and its iteration
    saver_base = loop.ModelSaver

    class TimedSaver(saver_base):
        def __call__(self, out_dir, model, optimizer, cfg, epoch, iteration,
                     loss):
            t0 = time.perf_counter()
            saved = super().__call__(out_dir, model, optimizer, cfg, epoch,
                                     iteration, loss)
            seen.setdefault('save_s', []).append(time.perf_counter() - t0)
            seen['saved_iteration'] = iteration
            return saved

    setattr(loop, base.__name__, Recording)
    loop.batch_to_device = timed_to_device
    loop.ModelSaver = TimedSaver
    os.makedirs(run)
    recipe = ([a for a in RECIPE if a != '--model_uncert'] + ['--model_inn']
              if inn else RECIPE)
    args = [run, '--train_trainset', train, '--train_valset', val,
            *recipe, '--train_steps', str(steps), '--train_nan_guard']
    if trunk:
        args.append('--pallas_trunk')
    if bf16:
        args += ['--bf16'] if host else ['--bf16', '--cache_bf16']
    if host:
        args.append('--host_pipeline')
    if unet:
        args.append('--model_unet')
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launches(M)
    t = time.time()
    try:
        state = cli.main(args, standalone_mode=False)
        torch.cuda.synchronize()
    finally:
        setattr(loop, base.__name__, base)
        loop.batch_to_device = to_device
        loop.ModelSaver = saver_base
    wall = time.time() - t
    launches = read_launches(M)
    peak = torch.cuda.max_memory_allocated()

    accum = int(RECIPE[RECIPE.index('--train_accum') + 1])
    # the U-Net turns the fused trunk off, as in the JAX package
    k3 = TRUNK_BLOCKS * accum * steps if trunk and not unet else 0
    sfx = '_bf16' if bf16 else ''
    k1 = 'window_gather' + ('_bf16' if bf16 and not host else '')
    want = expected(M, **{k1: 0 if host else steps * accum,
                          f'fused_double_conv_fwd{sfx}': k3,
                          f'fused_double_conv_bwd{sfx}': k3})
    if launches != want:
        raise AssertionError(f'launches {launches} in {steps} steps x '
                             f'{accum} microbatches, expected {want}')
    if state.step != steps:
        raise AssertionError(f'train stopped at step {state.step}')
    rows = [[float(v) for v in line.split(',')] for line in
            open(os.path.join(run, 'log.csv')).read().splitlines()[1:]]
    if [int(r[0]) for r in rows] != list(range(steps)) or \
            not np.isfinite(np.array(rows)).all():
        raise AssertionError(f'log.csv rows {rows}')
    ckpt = torch.load(os.path.join(run, 'checkpoint.pt'),
                      map_location='cpu', weights_only=True)
    hyper = ckpt['hyper_parameters']
    if ckpt['iteration'] != steps or \
            ckpt['optimizer_state_dict'] is None or \
            hyper['pallas_trunk'] != trunk or hyper['bf16'] != bf16 or \
            hyper['cache_bf16'] != (bf16 and not host) or \
            hyper['host_pipeline'] != host or hyper['model_unet'] != unet \
            or hyper['model_inn'] != inn:
        raise AssertionError('checkpoint.pt does not hold the final step')
    if ckpt['iteration'] != seen['saved_iteration']:
        raise AssertionError(f'checkpoint.pt holds iteration '
                             f'{ckpt["iteration"]}, the last save was '
                             f'{seen["saved_iteration"]}')
    del state

    pipe, batch = seen['pipeline'], seen['batch']
    size = len(batch.aug.shift) // accum
    if not host:
        # K1 on the run's own last batch, microbatch by microbatch
        from mmlf_tpu_torch.data.pipeline import chunk_slice
        for c in range(accum):
            check_gather(M.W, pipe.cache, chunk_slice(batch, c * size,
                                                      (c + 1) * size),
                         pipe.win, f'train batch chunk {c}')

    name = 'train' + ('_unet' if unet else '') + ('_inn' if inn else '') \
        + ('_host' if host else '') + ('_bf16' if bf16 else '') \
        + ('_trunk' if trunk else '')
    bs = int(RECIPE[RECIPE.index('--train_bs') + 1])
    ps = int(RECIPE[RECIPE.index('--train_ps') + 1])
    steady = [r[5] for r in rows[1:]]
    s_step = sum(steady) / len(steady)
    flop = 3 * (inn_flop_per_pixel() if inn else conv_flop_per_pixel()) \
        * ps * ps * bs
    flops = '' if unet else (
        f'{flop / s_step / 1e12:.1f} TFLOP/s conv fwd+bwd '
        f'{"bf16" if bf16 else "fp32"} ({flop / 1e12:.1f} TFLOP/step, 3 x '
        f'forward), ')
    host_ms = ''
    if host:
        ms = {k: [round(x * 1e3, 1) for x in seen[k]]
              for k in ('sample_s', 'copy_s')}
        host_ms = (f'host sampler {ms["sample_s"]} ms per batch of {bs}, '
                   f'host-to-device copy {ms["copy_s"]} ms, ')
    log(f'{name}: {steps} steps of bs {bs} ({accum} x {size}), ps {ps}, '
        f'in {wall:.1f} s CLI wall; steady steps {steady} s, '
        f'{s_step:.3f} s/step, {bs / s_step:.1f} patches/s, {flops}'
        f'{host_ms}peak device memory {peak / 2**30:.2f} GiB, launches '
        f'{launches}, losses {[r[1] for r in rows]}; the rolling '
        f'checkpoint\'s snapshots blocked the step loop '
        f'{[round(x * 1e3, 1) for x in seen["save_s"]]} ms (written on the '
        f'saver\'s thread, iteration {seen["saved_iteration"]})')
    return {'launches': launches, 'pipeline': pipe, 's_step': s_step,
            'size': size, 'peak': peak, 'first': seen.get('first'),
            'sample_s': seen['sample_s'], 'copy_s': seen['copy_s'],
            'hyper': hyper}


def phase_window_gather(W, pipe, size: int) -> dict:
    """K1 at the recipe shape (a fresh batch of the run's pipeline, all
    four levels present) against its plain version; times of the kernel,
    the plain version, one advanced-indexing call on a one-level batch,
    the augmentation and the host sampler."""
    import numpy as np
    import torch
    from mmlf_tpu_torch.data.pipeline import gather_augment

    cache, win, ps = pipe.cache, pipe.win, pipe.ps
    img_bytes = cache.img[0].element_size()
    name = 'window_gather' + ('_bf16' if img_bytes == 2 else '')
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
        bound_ms, n_bytes = window_gather_bound(size, win, ci, with_mpi,
                                                img_bytes)
        out[with_mpi] = (ms, plain_ms, bound_ms)
        log(f'kernel {name} B={size} win={win} CI={ci} '
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
    log(f'kernel {name} one-level batch: {one_level_ms:.4f} ms, '
        f'advanced indexing (img + aux) {library_ms:.4f} ms')

    aug_ms = cuda_ms(lambda: gather_augment(cache, batch, ps, win,
                                            with_mpi=False), reps=10)
    t = time.perf_counter()
    for _ in range(5):
        pipe.sample_batch(size * 8)
    sampler_s = (time.perf_counter() - t) / 5
    log(f'input path ({name}) per microbatch of {size}: gather + '
        f'augmentation '
        f'{aug_ms:.3f} ms (K1 {out[False][0]:.4f} ms of it); host sampler '
        f'{sampler_s * 1e3:.1f} ms per batch of {size * 8}')
    ms, plain_ms, bound_ms = out[False]
    return {'max_abs_err': err, 'ms': ms, 'plain_ms': plain_ms,
            'bound_ms': bound_ms, 'bound_by': 'bytes',
            'library_ms': library_ms, 'aug_ms': aug_ms,
            'sampler_s': sampler_s}


def k3_inputs(b, h, w, cin, cout, seed):
    """Seeded dyadic inputs of one K3 block on the card (few-bit multiples
    of powers of two: x·si + ti and y1 are exact in fp32 in any order, so
    the ReLU masks of kernel and plain version agree bit for bit)."""
    import numpy as np
    import torch
    rng = np.random.default_rng(seed)

    def t(lo, hi, shape, scale):
        a = rng.integers(lo, hi + 1, shape).astype(np.float32) * scale
        return torch.from_numpy(a).cuda()

    x = t(-4, 4, (b, cin, h, w), 1 / 4)
    si, ti = t(2, 6, cin, 1 / 4), t(-4, 4, cin, 1 / 8)
    w1, b1 = t(-3, 3, (cout, cin, 2, 2), 1 / 16), t(-2, 2, cout, 1 / 16)
    w2, b2 = t(-3, 3, (cout, cout, 2, 2), 1 / 16), t(-2, 2, cout, 1 / 16)
    dy2 = t(-4, 4, (b, cout, h, w), 1 / 4)
    dps, dpss = t(-2, 2, cout, 1 / 16), t(-2, 2, cout, 1 / 256)
    return x, si, ti, w1, b1, w2, b2, dy2, dps, dpss


def k3_bound(b, h, w, cin, cout, peak=PEAK_3XTF32, eb=4):
    """Least times of K3 on the card, ``((fwd ms, by), (bwd ms, by))``.
    Operations: the forward's two k=2 convs (to (H+1)x(W+1) and HxW); the
    backward's five (y1 again, two dgrads, two wgrads), 2 FLOP per
    multiply-add at ``peak`` (fp32-accurate products: 3xTF32 on the tensor
    cores; ``PEAK_FP32`` gives the FFMA bound as context; the bf16
    instance's products at ``PEAK_BF16``).  Bytes: each input read once,
    each output written once (fwd: x, y2; bwd: x, y2, dy2, dx; plus
    weights), ``eb`` bytes an activation or weight element (2 for bf16),
    4 a vector element."""
    p1, p0 = b * (h + 1) * (w + 1), b * h * w
    c1, c2 = 2 * 4 * cin * cout, 2 * 4 * cout * cout
    ops_f = p1 * c1 + p0 * c2
    ops_b = 2 * p1 * c1 + p1 * c2 + p0 * c1 + p0 * c2
    act_in, act_out = b * cin * h * w, b * cout * h * w
    weights, vectors = 4 * cin * cout + 4 * cout * cout, 2 * cin + 2 * cout
    by_f = eb * (act_in + act_out + weights) + 4 * (vectors + 2 * cout)
    by_b = eb * (2 * act_in + 2 * act_out + 2 * weights) + \
        4 * (2 * vectors + 2 * cout)

    def bound(ops, n_bytes):
        t_ops, t_bytes = ops / peak, n_bytes / PEAK_BYTES
        return (max(t_ops, t_bytes) * 1e3,
                'operations' if t_ops >= t_bytes else 'bytes')
    return bound(ops_f, by_f), bound(ops_b, by_b)


def k3_real_inputs(b, h, w, cin, cout, seed):
    """Seeded real-valued inputs of one K3 block on the card (no operand is
    exact in TF32) for ``relu_in=False``, with b1 large enough that
    y1 > 0 everywhere: no ReLU mask can flip, so the whole block is
    continuous and its error is the arithmetic's alone."""
    import numpy as np
    import torch
    rng = np.random.default_rng(seed)

    def t(a):
        return torch.from_numpy(np.asarray(a, np.float32)).cuda()

    x = t(rng.standard_normal((b, cin, h, w)))
    si, ti = t(rng.uniform(0.5, 1.5, cin)), t(rng.uniform(-0.5, 0.5, cin))
    w1 = t(rng.standard_normal((cout, cin, 2, 2)) / math.sqrt(4 * cin))
    b1 = t(rng.uniform(10.0, 11.0, cout))
    w2 = t(rng.standard_normal((cout, cout, 2, 2)) / math.sqrt(4 * cout))
    b2 = t(rng.uniform(-0.1, 0.1, cout))
    dy2 = t(rng.standard_normal((b, cout, h, w)))
    dps, dpss = t(rng.standard_normal(cout) * 0.1), \
        t(rng.standard_normal(cout) * 0.01)
    return x, si, ti, w1, b1, w2, b2, dy2, dps, dpss


def k3_precision(C, b, h, w, cin, cout, seed) -> dict:
    """K3 forward and backward on real-valued inputs against a float64
    evaluation of the plain version: each output's max abs error must stay
    within ``K3_PREC_FACTOR`` x the fp32 plain version's (cuDNN, TF32 off;
    floored at one fp32 ulp of the output's largest magnitude).  Returns
    ``{output: (kernel err, plain err)}``."""
    import torch
    from torch.nn import functional as F
    x, si, ti, w1, b1, w2, b2, dy2, dps, dpss = k3_real_inputs(
        b, h, w, cin, cout, seed)
    fa = (x, si, ti, w1, b1, w2, b2, False, True)
    d = [a.double() for a in (x, si, ti, w1, b1, w2, b2)]
    y1_min = float(F.conv2d(d[0] * d[1][:, None, None] + d[2][:, None, None],
                            d[3], d[4], padding=1).min())
    if y1_min <= 0:
        raise AssertionError(f'K3 precision inputs: min y1 {y1_min} <= 0')
    want = C.plain_double_conv_fwd(*d, False, True)
    outs = {'fwd': (C.fused_double_conv_fwd(*fa),
                    C.plain_double_conv_fwd(*fa), want,
                    ('y2', 'ps', 'pss'))}
    y2 = outs['fwd'][1][0]          # the same y2 residual for all three
    ba = (x, si, ti, w1, b1, w2, y2, dy2, dps, dpss, False, True)
    want_b = C.plain_double_conv_bwd(*d[:6], y2.double(), dy2.double(),
                                     dps.double(), dpss.double(), False, True)
    outs['bwd'] = (C.fused_double_conv_bwd(*ba), C.plain_double_conv_bwd(*ba),
                   want_b, ('dx', 'dsi', 'dti', 'dw1', 'db1', 'dw2', 'db2'))
    torch.cuda.synchronize()
    res = {}
    for kind, (got, plain, ref, names) in outs.items():
        for g, p, r, name in zip(got, plain, ref, names):
            e_k = float((g.double() - r).abs().max())
            e_p = float((p.double() - r).abs().max())
            floor = 2.0 ** -24 * float(r.abs().max())
            if e_k > K3_PREC_FACTOR * max(e_p, floor):
                raise AssertionError(
                    f'K3 {kind} {cin}->{cout} {name} on real-valued inputs: '
                    f'error vs float64 {e_k:.3e} > {K3_PREC_FACTOR} x the '
                    f'fp32 plain version\'s {e_p:.3e}')
            res[name] = (e_k, e_p)
    return res


def bwd_split(rows) -> tuple:
    """``(conv GEMMs, weight gradients, rest)`` device ms of a K3 backward
    from its profiler rows ``(kernel name, ms, count)``: conv2x2_kernel,
    wgrad_kernel and every other kernel."""
    conv = sum(ms for key, ms, _ in rows if 'conv2x2_kernel' in key)
    wgrad = sum(ms for key, ms, _ in rows if 'wgrad_kernel' in key)
    return conv, wgrad, sum(ms for _, ms, _ in rows) - conv - wgrad


def profile_rows(fn, args, calls: int = 3) -> list:
    """Device time by CUDA kernel of ``fn(*args)`` (torch.profiler, the
    mean of ``calls`` calls after one warm-up): ``[(name, ms, count)]``,
    largest first; empty when the profiler saw no device time."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    fn(*args)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn(*args)
        torch.cuda.synchronize()
    return sorted(((e.key, e.device_time_total / 1e3 / calls,
                    e.count // calls)
                   for e in prof.key_averages()
                   if e.device_time_total > 0), key=lambda r: -r[1])


def k3_breakdown(C, fa, ba, tag: str = '') -> None:
    """Device time by CUDA kernel of one K3 forward and one backward
    (``profile_rows``), to show where a block's time goes, and the
    backward's split into its conv GEMMs (conv2x2_kernel), its weight
    gradients (wgrad_kernel) and the rest."""
    for name, fn, args in (('fwd', C.fused_double_conv_fwd, fa),
                           ('bwd', C.fused_double_conv_bwd, ba)):
        rows = profile_rows(fn, args)
        if not rows:
            log(f'k3 breakdown{tag} {name}: the profiler saw no device time')
            continue
        log(f'k3 breakdown{tag} {name} (280->280, profiler device ms a '
            f'call): ' + '; '.join(f'{k[:60]} x{n} {ms:.3f}'
                                   for k, ms, n in rows[:8]))
        if name == 'bwd':
            conv, wgrad, rest = bwd_split(rows)
            log(f'k3 breakdown{tag} bwd split (280->280, device ms a call): '
                f'conv GEMMs (conv2x2_kernel) {conv:.3f}, weight gradients '
                f'(wgrad_kernel) {wgrad:.3f}, other {rest:.3f}')


def bf16_instances(report: str) -> str:
    """Registers and spill-store bytes of each bf16 conv2x2_kernel instance
    (tile rows x columns, output type) and each bf16 wgrad_kernel
    instance (rows x columns) in conv_block's ptxas -v report."""
    rows = []
    for entry in report.split('Compiling entry function')[1:]:
        conv = re.search(r"conv2x2_kernelINS_\d+(Span)?CfgILi(\d+)ELi(\d+)E"
                         r"(NS_4Bf16E)?EE(\w)", entry)
        wgrad = re.search(r"wgrad_kernelINS_\d+WgradSpanCfgILi(\d+)E", entry)
        regs = re.search(r'Used (\d+) registers', entry)
        spill = re.search(r'(\d+) bytes spill stores', entry)
        if not (regs and spill):
            continue
        if conv and (conv.group(1) or conv.group(4)):
            out = {'f': 'fp32 out', 't': 'bf16 out'}.get(conv.group(5), '?')
            what = (f'conv2x2 {128 * int(conv.group(2))}x{conv.group(3)} '
                    f'{out}')
        elif wgrad:
            what = f'wgrad 128x{wgrad.group(1)}'
        else:
            continue
        rows.append(f'{what}: {regs.group(1)} regs / {spill.group(1)} B '
                    f'spilled')
    return ', '.join(rows)


def k3_bf16_check(got, plain, ref, what: str) -> float:
    """K3's bf16 instance against its plain version evaluated in float64
    (``ref``: bf16 activations, float64 parameters, the same rounding
    points, every sum in float64), beside the float32 plain version
    (``plain``: fp32 convs, TF32 off).  A later fp32 sum may put a value
    the other side of a bf16 rounding boundary (y2, g2, dy1's bf16 copy,
    dx) and a flipped dy1 moves the dgrad over it, which cuDNN's fp32 dgrad
    does to ~0.04% of dx at 280->280.  So the max error against ``ref``
    must stay within K3_PREC_FACTOR x the float32 plain version's (floored
    at one ulp of the largest magnitude in the output's dtype), and the
    share of bf16 elements more than one ulp (at most 2^-7 of the
    magnitude) off within the float32 plain version's (floored at 1e-5).
    Returns the kernel's max abs error against ``ref``."""
    import torch

    def errors(t):
        d = (t.double() - ref.double()).abs()
        off = 0.0
        if t.dtype == torch.bfloat16:
            off = float((d > 2.0 ** -7 * ref.double().abs() + 1e-12)
                        .double().mean())
        return float(d.max()), off

    (e_k, s_k), (e_p, s_p) = errors(got), errors(plain)
    ulp = 2.0 ** (-8 if got.dtype == torch.bfloat16 else -24)
    floor = ulp * float(ref.abs().max())
    if got.dtype != plain.dtype or e_k > K3_PREC_FACTOR * max(e_p, floor) \
            or s_k > max(s_p, 1e-5):
        raise AssertionError(
            f'{what}: error vs float64 {e_k:.3e} (fp32 plain {e_p:.3e}), '
            f'share beyond one ulp {s_k:.2e} (fp32 plain {s_p:.2e})')
    return e_k


def k3_bf16_ragged(C) -> None:
    """K3's bf16 instance at ragged shapes, each output held by
    ``k3_bf16_check``: (3, 13, 17) and (3, 12, 14) give each weight
    gradient a stage that crosses an image, an odd pixel count an image
    (dW2's 13 x 17, dW1's 13 x 15) and a last stage past the end (M % 32
    != 0)."""
    import torch
    for b, h, w in K3_RAGGED:
        for (cin, cout, relu_in, affine_in), _ in K3_BLOCKS[:3]:
            x, si, ti, w1, b1, w2, b2, dy2, dps, dpss = k3_inputs(
                b, h, w, cin, cout, seed=cin + cout + h)
            x, dy2 = x.bfloat16(), dy2.bfloat16()
            dbl = [a.double() for a in (si, ti, w1, b1, w2, b2, dps, dpss)]
            y2 = C.plain_double_conv_fwd(x, *dbl[:6], relu_in, affine_in)[0]
            ba = (x, si, ti, w1, b1, w2, y2, dy2, dps, dpss, relu_in,
                  affine_in)
            got, plain = C.fused_double_conv_bwd(*ba), \
                C.plain_double_conv_bwd(*ba)
            ref = C.plain_double_conv_bwd(x, *dbl[:5], y2, dy2, *dbl[6:],
                                          relu_in, affine_in)
            torch.cuda.synchronize()
            errs = [k3_bf16_check(g, p, r, f'K3 bf16 bwd {cin}->{cout} '
                                  f'B={b} {h}x{w} {name}')
                    for g, p, r, name in zip(got, plain, ref, (
                        'dx', 'dsi', 'dti', 'dw1', 'db1', 'dw2', 'db2'))]
            log(f'K3 bf16 bwd {cin}->{cout} B={b} {h}x{w} (ragged): max abs '
                f'err vs float64 dx {errs[0]:.2e}, dw1 {errs[3]:.2e}, db1 '
                f'{errs[4]:.2e}, dw2 {errs[5]:.2e}, db2 {errs[6]:.2e}')


def phase_conv_block(M, bf16: bool = False) -> dict:
    """K3's precision on real-valued inputs (``k3_precision``, float32),
    then K3 forward and backward against their plain versions at the
    recipe's block shapes (B 64, 96²), with the times of kernel, plain
    version and the port's plain ConvBlock (cuDNN fwd and autograd bwd);
    the totals over one microbatch's 20 blocks go into the kernels line.
    ``bf16``: the bf16 instance on bf16 canvases at the recipe's blocks,
    held by ``k3_bf16_check`` against the plain version evaluated in
    float64 (the max abs error reported is against that evaluation), its
    bound at the dense bf16 tensor-core
    peak, and cuDNN's bf16 ConvBlock (the port's ``--bf16`` plain block)
    as context."""
    import torch
    from mmlf_tpu_torch.models.feed_forward import _block_bf16, conv_block

    C = M.C
    tag = ' bf16' if bf16 else ''
    if not bf16:
        for size in ((64, 96, 96), (3, 13, 17)):
            res = k3_precision(C, *size, 280, 280, seed=sum(size))
            log(f'K3 precision 280->280 B={size[0]} {size[1]}x{size[2]} '
                f'(real-valued, relu_in False, y1 > 0): max abs err vs '
                f'float64, kernel / fp32 plain: '
                + ', '.join(f'{k} {e:.2e}/{p:.2e}'
                            for k, (e, p) in res.items())
                + f' (limit {K3_PREC_FACTOR}x)')
    torch.cuda.empty_cache()
    b, h, w = 64, 96, 96
    out = {'fwd': dict(ms=0.0, plain_ms=0.0, bound_ms=0.0, err=0.0, n=0),
           'bwd': dict(ms=0.0, plain_ms=0.0, bound_ms=0.0, err=0.0, n=0)}
    by = {kind: {'operations': 0.0, 'bytes': 0.0} for kind in out}
    for (cin, cout, relu_in, affine_in), n in K3_BLOCKS:
        if bf16 and not n:
            continue                 # the bf16 phase times the recipe's
        x, si, ti, w1, b1, w2, b2, dy2, dps, dpss = k3_inputs(
            b, h, w, cin, cout, seed=cin + cout)
        if bf16:
            x, dy2 = x.bfloat16(), dy2.bfloat16()
        fa = (x, si, ti, w1, b1, w2, b2, relu_in, affine_in)
        got = C.fused_double_conv_fwd(*fa)
        want = C.plain_double_conv_fwd(*fa)
        dbl = [a.double() for a in (si, ti, w1, b1, w2, b2, dps, dpss)]
        ref = C.plain_double_conv_fwd(x, *dbl[:6], relu_in, affine_in) \
            if bf16 else want
        y2 = ref[0] if bf16 else want[0]
        ba = (x, si, ti, w1, b1, w2, y2, dy2, dps, dpss, relu_in, affine_in)
        got_b = C.fused_double_conv_bwd(*ba)
        want_b = C.plain_double_conv_bwd(*ba)
        ref_b = C.plain_double_conv_bwd(
            x, *dbl[:5], y2, dy2, *dbl[6:], relu_in, affine_in) \
            if bf16 else want_b
        torch.cuda.synchronize()
        errs = {}
        for kind, g_, w_, r_, names in (
                ('fwd', got, want, ref, ('y2', 'ps', 'pss')),
                ('bwd', got_b, want_b, ref_b, ('dx', 'dsi', 'dti', 'dw1',
                                               'db1', 'dw2', 'db2'))):
            for g, wt, r, name in zip(g_, w_, r_, names):
                scale = float(r.abs().max())
                what = f'K3{tag} {kind} {cin}->{cout} {name}'
                if bf16:
                    err = k3_bf16_check(g, wt, r, what)
                else:
                    err = float((g - wt).abs().max())
                    if err > K3_REL * scale:
                        raise AssertionError(
                            f'{what}: max abs err {err:.3e} > {K3_REL} x '
                            f'max |plain| {scale:.3e}')
                errs[name] = err / scale if scale else 0.0
                out[kind]['err'] = max(out[kind]['err'], err)
        del got, got_b, want_b, ref, ref_b, dbl

        ms_f = cuda_ms(lambda: C.fused_double_conv_fwd(*fa), reps=5)
        ms_b = cuda_ms(lambda: C.fused_double_conv_bwd(*ba), reps=5)
        plain_f = cuda_ms(lambda: C.plain_double_conv_fwd(*fa), reps=5)
        plain_b = cuda_ms(lambda: C.plain_double_conv_bwd(*ba), reps=5)
        if bf16:
            (bound_f, by_f), (bound_b, by_b) = k3_bound(
                b, h, w, cin, cout, PEAK_BF16, eb=2)
            context = ''
        else:
            (bound_f, by_f), (bound_b, by_b) = k3_bound(b, h, w, cin, cout)
            (ffma_f, _), (ffma_b, _) = k3_bound(b, h, w, cin, cout,
                                                PEAK_FP32)
            context = f'; FFMA bound {ffma_f:.3f} / {ffma_b:.3f} ms'

        # context: the port's plain ConvBlock (conv, relu, conv, BN, relu)
        # through cuDNN, forward and autograd backward (bf16: as --bf16
        # runs it)
        blk = conv_block(cin, cout, 2, True).cuda().train()
        xb = x.clone().requires_grad_()

        def cudnn_fwd():
            return _block_bf16(blk, xb) if bf16 else blk(xb)
        cudnn_f = cuda_ms(cudnn_fwd, reps=5)

        def fwd_bwd():
            cudnn_fwd().backward(dy2)
        cudnn_fb = cuda_ms(fwd_bwd, reps=5)
        del blk, xb
        if (cin, cout) == (280, 280):
            k3_breakdown(C, fa, ba, tag)
        log(f'kernel fused_double_conv{tag} {cin}->{cout} B={b} {h}x{w} '
            f'(relu_in {relu_in}, affine_in {affine_in}): fwd {ms_f:.3f} ms '
            f'(bound {bound_f:.3f} ms, {by_f}; plain {plain_f:.3f} ms), '
            f'bwd {ms_b:.3f} ms (bound {bound_b:.3f} ms, {by_b}; plain '
            f'{plain_b:.3f} ms){context}; cuDNN{tag} ConvBlock fwd '
            f'{cudnn_f:.3f} ms, bwd {cudnn_fb - cudnn_f:.3f} ms; max err / '
            f'max |plain| '
            + ', '.join(f'{k} {v:.1e}' for k, v in errs.items()))
        for kind, ms, plain, bound, bound_by in (
                ('fwd', ms_f, plain_f, bound_f, by_f),
                ('bwd', ms_b, plain_b, bound_b, by_b)):
            out[kind]['ms'] += n * ms
            out[kind]['plain_ms'] += n * plain
            out[kind]['bound_ms'] += n * bound
            out[kind]['n'] += n
            by[kind][bound_by] += n * bound
        del x, si, ti, w1, b1, w2, b2, dy2, dps, dpss, fa, ba, y2, want
        torch.cuda.empty_cache()
    if bf16:
        k3_bf16_ragged(C)
    for kind in ('fwd', 'bwd'):
        o = out[kind]
        o['bound_by'] = max(by[kind], key=by[kind].get)
        log(f'kernel fused_double_conv_{kind}{tag}: one microbatch\'s '
            f'{o["n"]} blocks {o["ms"]:.2f} ms, plain {o["plain_ms"]:.2f} '
            f'ms, bound {o["bound_ms"]:.2f} ms (mostly {o["bound_by"]})')
    return out


def phase_main(M, run: str, val: str) -> dict:
    """ESE validate of the train phase's checkpoint through the CLI."""
    import numpy as np
    import torch
    from mmlf_tpu_torch.validate import cli

    K = M.K
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launches(M)
    t = time.time()
    result = cli.main([run, val, '--val_ensamble'], standalone_mode=False)
    torch.cuda.synchronize()
    wall = time.time() - t
    counts = read_launches(M)
    launches = counts['laplace_mixture_posterior']
    peak = torch.cuda.max_memory_allocated()

    for key in METRICS:
        if not math.isfinite(result[key]):
            raise AssertionError(f'metric {key} = {result[key]}')
    if counts != expected(M, laplace_mixture_posterior=1):
        raise AssertionError(f'ESE validate of 1 scene launched {counts}')
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

    log('main: metrics of the checkpoint (random weights trained a few '
        'steps at most: the values mean nothing) '
        + json.dumps({k: result[k] for k in METRICS}))
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
    from mmlf_tpu_torch.utils import pfm
    return {'launches': launches, 'max_abs_err': err,
            's_per_scene': result['runtime'], 'wall_s': wall,
            'peak_bytes': peak, 'gmm': gmm, 'posterior': post,
            'result': pfm.load(os.path.join(scene, 'result.pfm')),
            'metrics': {k: result[k] for k in METRICS}}


def phase_main_tiled(M, run: str, val: str, gmm_whole,
                     metrics_whole) -> dict:
    """ESE validate of the same checkpoint with ``--val_tile``: K2 once per
    tile, and the member means and logvars, the selected member and the
    metrics against the whole-scene run's (``gmm_whole``, phase main's
    gmm.npy, and ``metrics_whole``)."""
    import numpy as np
    import torch
    from mmlf_tpu_torch.ops.masks import create_mask_margin_np
    from mmlf_tpu_torch.validate import cli
    from mmlf_tpu_torch.validate.tiling import tile_positions

    n_tiles = len(tile_positions(SIZE, SIZE, VAL_TILE, VAL_HALO))
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launches(M)
    t = time.time()
    result = cli.main([run, val, '--val_ensamble', '--val_tile',
                       str(VAL_TILE)], standalone_mode=False)
    torch.cuda.synchronize()
    wall = time.time() - t
    counts = read_launches(M)
    peak = torch.cuda.max_memory_allocated()
    for key in METRICS:
        if not math.isfinite(result[key]):
            raise AssertionError(f'tiled metric {key} = {result[key]}')
    if counts != expected(M, laplace_mixture_posterior=n_tiles):
        raise AssertionError(f'tiled ESE validate of 1 scene in {n_tiles} '
                             f'tiles launched {counts}')
    gmm = np.load(os.path.join(run, 'scenes', 'scene_00', 'gmm.npy'))
    if gmm.shape != gmm_whole.shape or not np.isfinite(gmm).all():
        raise AssertionError(f'tiled gmm.npy {gmm.shape}')

    # gmm.npy holds (means, exp(logvars)) of the 70 members
    d_mean = np.abs(gmm[0] - gmm_whole[0])
    d_lv = np.abs(np.log(gmm[1]) - np.log(gmm_whole[1]))
    sel = np.argmin(gmm[1], 0) != np.argmin(gmm_whole[1], 0)
    diffs = {}
    for margin in (15, TILED_EXACT_MARGIN):
        m = create_mask_margin_np((SIZE, SIZE), margin)
        diffs[margin] = (float(d_mean[:, m].max()), float(d_lv[:, m].max()),
                         float(sel[m].mean()))
    dm, dl, share = diffs[TILED_EXACT_MARGIN]
    if dm > 1e-4 or dl > 1e-4 or share > 1e-3:
        raise AssertionError(
            f'tiled ESE vs whole scene at margin {TILED_EXACT_MARGIN}: '
            f'means {dm:.3e}, logvars {dl:.3e} (limit 1e-4), selected '
            f'member differs at {share:.2e} of pixels (limit 1e-3)')
    log(f'main_tiled: ESE validate with --val_tile {VAL_TILE} ({n_tiles} '
        f'windows of {VAL_WINDOW}², halo {VAL_HALO}): '
        f'{result["runtime"]:.3f} s/scene (CLI runtime), {wall:.3f} s CLI '
        f'wall, peak device memory {peak / 2**30:.3f} GiB, mixture '
        f'posterior launches {counts["laplace_mixture_posterior"]}; against '
        f'the whole-scene run, max |d means| / |d logvars| / share of '
        f'pixels whose selected member differs: '
        + '; '.join(f'margin {mg}: {a:.3e} / {b:.3e} / {c:.2e}'
                    for mg, (a, b, c) in diffs.items())
        + f' (limits 1e-4 / 1e-4 / 1e-3 at margin {TILED_EXACT_MARGIN})')
    log('main_tiled: metrics ' + json.dumps(
        {k: result[k] for k in METRICS}) + '; minus the whole-scene run\'s '
        '(margin-15 mask; the windows\' view shifts wrap at their edges) '
        + json.dumps({k: result[k] - metrics_whole[k] for k in METRICS}))
    return {'launches': counts['laplace_mixture_posterior'],
            's_per_scene': result['runtime'], 'peak_bytes': peak}


def decision_ties(gmm_cnt, means, variances, grid, rel: float):
    """(G, P): the local-maximum decisions (d[g] against d[g-1] and
    d[g+1]) of a (K, P) mixture on ``grid`` whose float64 values lie
    within ``rel`` of each other: there the float32 test may go either
    way."""
    import torch
    d = gmm_cnt.mixture_on_grid(means.double(), variances.double(),
                                grid.double())
    close = (d[1:] - d[:-1]).abs() <= rel * torch.maximum(d[1:], d[:-1])
    ties = torch.zeros_like(d, dtype=torch.bool)
    ties[1:-1] = close[:-1] | close[1:]
    return ties


def phase_analysis(run: str, val: str, card: str) -> None:
    """The analysis CLIs, each through its ``main``, on phase main's output
    (the ESE validation of one 512² scene: gmm.npy of 70 members, the
    posterior of 70 bins): sparsify, cluster, modecnt, multimodal (--uni,
    --multi, --lb), mm_prediction, gmm_cnt on the card at its default grid
    (1400 points), gmm2csv and post2csv at one pixel, uncert2csv, and
    edges on the val dataset; each CLI's wall time and gmm_cnt's device
    time (CUDA events around its ``count_modes``).  Then ``count_modes``
    on the card against its CPU path on one chunk of pixels."""
    import contextlib
    import io
    import numpy as np
    import torch
    from mmlf_tpu_torch.utils import (gmm2csv, gmm_cnt, modecnt, pfm,
                                      post2csv, uncert2csv)
    from mmlf_tpu_torch.validate import (cluster, edges, mm_prediction,
                                         multimodal, sparsify)

    scene = os.path.join(run, 'scenes', 'scene_00')
    out = os.path.join(run, 'analysis')
    os.makedirs(out)
    x, y = ANALYSIS_PIXEL
    walls, last = {}, {}
    maps = []
    device_ms = []
    count_modes = gmm_cnt.count_modes

    def timed_count_modes(*a, **kw):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        start.record()
        result = count_modes(*a, **kw)
        end.record()
        torch.cuda.synchronize()
        device_ms.append(start.elapsed_time(end))
        maps.append(result)
        return result

    steps = [
        ('sparsify', sparsify.main, [run]),
        ('cluster', cluster.main, [run]),
        ('modecnt', modecnt.main, [run]),
        ('multimodal --uni', multimodal.main, [run, '--uni']),
        ('multimodal --multi', multimodal.main, [run, '--multi']),
        ('multimodal --lb', multimodal.main, [run, '--lb']),
        ('mm_prediction', mm_prediction.main, [run]),
        ('gmm_cnt', gmm_cnt.main, [scene, scene]),
        ('gmm2csv', gmm2csv.main, [os.path.join(scene, 'gmm.npy'),
                                   os.path.join(out, f'gmm_{x}_{y}.csv'),
                                   x, y, '--sum_only']),
        ('post2csv', post2csv.main, [scene, x, y]),
        ('uncert2csv', uncert2csv.main,
         [os.path.join(scene, 'result.pfm'), os.path.join(scene, 'uncert.pfm'),
          os.path.join(out, f'uncert_{x}_{y}.csv'), x, y]),
        ('edges', edges.main, [val]),
    ]
    cwd = os.getcwd()
    gmm_cnt.count_modes = timed_count_modes
    # multimodal writes its per-scene PNGs into the working directory
    os.chdir(out)
    try:
        for name, main, args in steps:
            text = io.StringIO()
            t = time.time()
            with contextlib.redirect_stdout(text):
                main(args, standalone_mode=False)
            walls[name] = time.time() - t
            with open(os.path.join(out, name.replace(' ', '') + '.txt'),
                      'w') as fh:
                fh.write(text.getvalue())
            lines = text.getvalue().strip().splitlines()
            last[name] = lines[-1] if lines else ''
    finally:
        os.chdir(cwd)
        gmm_cnt.count_modes = count_modes

    for f in ('sparsify.csv', 'mm_pred.csv', 'scenes/scene_00/gt_modes.npy',
              'scenes/scene_00/mode_prop.pfm', 'scenes/scene_00/cnts.png',
              'scenes/scene_00/result_best.png',
              'scenes/scene_00/second_chance.txt',
              f'scenes/scene_00/posterior_{x}_{y}.csv',
              f'scenes/scene_00/center_{x}_{y}.png',
              f'analysis/gmm_{x}_{y}.csv', f'analysis/uncert_{x}_{y}.csv',
              'analysis/mse_0.png'):
        if not os.path.exists(os.path.join(run, f)):
            raise AssertionError(f'analysis: {f} missing')
    if not os.path.exists(os.path.join(val, 'scene_00', 'edges.png')):
        raise AssertionError('analysis: edges.png of the val scene missing')
    for csv in ('sparsify.csv', 'mm_pred.csv'):
        table = np.genfromtxt(os.path.join(run, csv), delimiter=',',
                              skip_header=1)
        if table.shape != (100, 4) or not np.isfinite(table).all():
            raise AssertionError(f'analysis: {csv} rows {table.shape}')
    modes = np.load(os.path.join(scene, 'gt_modes.npy'))
    prop = pfm.load(os.path.join(scene, 'mode_prop.pfm'))
    if modes.shape != (SIZE, SIZE, 2) or prop.shape != (SIZE, SIZE) or \
            not np.isfinite(prop).all():
        raise AssertionError(f'analysis: gt_modes {modes.shape}, mode_prop '
                             f'{prop.shape}')
    (cnts, mode_min, mode_max), = maps
    has = cnts > 0
    if cnts.shape != (SIZE, SIZE) or cnts.min() < 0 or \
            not np.isfinite(mode_min).all() or \
            not (mode_min[has] <= mode_max[has]).all():
        raise AssertionError('analysis: gmm_cnt maps')
    for name in ('multimodal --uni', 'multimodal --multi', 'multimodal --lb',
                 'gmm_cnt'):
        values = [float(w) for w in last[name].split()
                  if not w.endswith(':')]
        if not values or not all(math.isfinite(v) for v in values):
            raise AssertionError(f'analysis: {name} printed {last[name]!r}')

    # the card's count_modes against the CPU path on one chunk of pixels
    gmm = np.load(os.path.join(scene, 'gmm.npy'))
    k = gmm.shape[1]
    rows = ANALYSIS_CHUNK // SIZE
    r0 = (SIZE - rows) // 2
    sub = np.ascontiguousarray(gmm[:, :, r0:r0 + rows])
    means = torch.from_numpy(sub[0].reshape(k, -1))
    variances = torch.from_numpy(sub[1].reshape(k, -1))
    grid = torch.from_numpy(np.arange(-3.5, 3.5, 0.005, dtype=np.float32))
    dev = torch.device('cuda')
    t = time.time()
    dens = gmm_cnt.mixture_on_grid(means.to(dev), variances.to(dev),
                                   grid.to(dev))
    dens_cpu = gmm_cnt.mixture_on_grid(means, variances, grid)
    vmin = float(variances.min())
    atol = float(np.finfo(np.float32).tiny) / (
        math.sqrt(2.0 * math.pi * vmin) * vmin)
    diff = (dens.cpu() - dens_cpu).abs()
    excess = (diff - ANALYSIS_RTOL * dens_cpu.abs() - atol).max().item()
    rel = (diff / dens_cpu.abs().clamp_min(
        float(np.finfo(np.float32).tiny))).max().item()
    if excess > 0:
        raise AssertionError(f'analysis: card density vs CPU, max rel '
                             f'{rel:.3e} (rtol {ANALYSIS_RTOL}, atol '
                             f'{atol:.3e})')
    # every local-maximum decision that the two densities take apart is a
    # near tie in float64
    is_max = gmm_cnt.local_maxima(dens)
    flips = (is_max.cpu() != gmm_cnt.local_maxima(dens_cpu)).to(dev)
    ties = decision_ties(gmm_cnt, means.to(dev), variances.to(dev),
                         grid.to(dev), ANALYSIS_TIE_REL)
    if (flips & ~ties).any():
        raise AssertionError(f'analysis: {int((flips & ~ties).sum())} '
                             f'local-maximum decisions differ between the '
                             f'card and the CPU without a near tie')
    # the card's count_modes gives the maps of the density checked here;
    # the CPU path's maps part from them only at pixels with a near tie
    got = gmm_cnt.count_modes(sub, -3.5, 3.5, 0.005, device='cuda')
    want = gmm_cnt.count_modes(sub, -3.5, 3.5, 0.005, device='cpu')
    for g, m in zip(got, gmm_cnt.mode_maps(is_max, -3.5, 0.005)):
        if not np.array_equal(g.reshape(-1), m.cpu().numpy()):
            raise AssertionError('analysis: count_modes on the card is not '
                                 'the maps of its own density')
    tied = ties.any(0).cpu().numpy().reshape(sub.shape[2:])
    differ = np.zeros(sub.shape[2:], bool)
    for g, w in zip(got, want):
        differ |= g != w
    if (differ & ~tied).any():
        raise AssertionError(f'analysis: card maps differ from the CPU path '
                             f'at {int((differ & ~tied).sum())} pixels '
                             f'without a near tie')
    n_flips, n_ties = int(flips.sum()), int(ties.sum())
    del dens, dens_cpu, diff, is_max, flips, ties
    check_s = time.time() - t

    log('analysis: CLI wall s ' + json.dumps(
        {n: round(w, 3) for n, w in walls.items()}) + f', total '
        f'{sum(walls.values()):.1f} s; card {card}')
    log(f'analysis: gmm_cnt count_modes on the card ({len(grid)} grid '
        f'points x {k} members x {SIZE * SIZE} pixels, chunks of 8192) '
        f'{device_ms[0]:.1f} ms by CUDA events (the gmm copy in, the maps '
        f'out); {last["gmm_cnt"]}; sparsify {last["sparsify"]}; '
        f'mm_prediction {last["mm_prediction"]}; multimodal --multi '
        f'{last["multimodal --multi"]}')
    log(f'analysis: count_modes card vs CPU on {ANALYSIS_CHUNK} pixels '
        f'(rows {r0}-{r0 + rows - 1}): density max rel {rel:.3e} (rtol '
        f'{ANALYSIS_RTOL}); {n_flips} of {len(grid) * ANALYSIS_CHUNK} '
        f'local-maximum decisions differ, all among the {n_ties} near '
        f'ties (rel {ANALYSIS_TIE_REL} in float64); the maps differ at '
        f'{int(differ.sum())} pixels ({differ.mean():.2e}), all with a '
        f'near tie ({tied.mean():.2e} of the pixels have one); '
        f'{check_s:.1f} s')


def _http(port: int, method: str, path: str, payload=None):
    """``(status, JSON body, wall seconds)`` of one request to the server on
    ``port``."""
    import urllib.error
    import urllib.request
    data = None if payload is None else json.dumps(payload).encode()
    req = urllib.request.Request(f'http://127.0.0.1:{port}{path}',
                                 data=data, method=method)
    t = time.perf_counter()
    try:
        with urllib.request.urlopen(req, timeout=600) as r:
            status, body = r.status, json.loads(r.read())
    except urllib.error.HTTPError as e:
        status, body = e.code, json.loads(e.read())
    return status, body, time.perf_counter() - t


def phase_serve(M, run: str, val: str, main_run: dict, card: str) -> dict:
    """Export the checkpoint in ``run`` as each of SERVE_ARTIFACTS, serve
    each through ``make_server`` on a thread and send it requests over
    HTTP (one warm-up, then SERVE_REQUESTS timed).  Checks: /healthz,
    status 200 on every request, the u8, batch-2 and tiled means against
    the fp32 one, the ESE result.pfm and metrics against phase main's
    (``main_run``), and K2 once per ESE request.  Returns the K2
    launches."""
    import statistics
    import threading
    import numpy as np
    import torch
    from mmlf_tpu_torch.export import export_inference
    from mmlf_tpu_torch.serve import InferenceEngine, make_server
    from mmlf_tpu_torch.utils import pfm

    work = os.path.join(os.path.dirname(run), 'serve')
    os.makedirs(work)
    scene = os.path.join(val, 'scene_00')
    # a second name for the val scene: a 2-scene request writes each
    # scene's results under its directory's name
    scene_b = os.path.join(work, 'scene_b')
    os.symlink(scene, scene_b)
    results, n_ese = {}, 0
    torch.cuda.synchronize()
    reset_launches(M)
    for name, kw in SERVE_ARTIFACTS:
        ese = kw.get('val_ensamble', False)
        t = time.time()
        blob = export_inference(run, SIZE, SIZE, **kw)
        art = os.path.join(work, f'{name}.mmlft')
        with open(art, 'wb') as f:
            f.write(blob)
        export_s = time.time() - t
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        engine = InferenceEngine(art)
        server = make_server(engine, '127.0.0.1', 0)
        thread = threading.Thread(target=server.serve_forever, daemon=True)
        thread.start()
        port = server.server_address[1]
        try:
            status, health, _ = _http(port, 'GET', '/healthz')
            shape = None if 'tiled' in kw else [SIZE, SIZE]
            if status != 200 or health['fixed_shape'] != shape or \
                    (ese and health['calibration']['status'] != 'unchecked'):
                raise AssertionError(f'serve {name}: /healthz {status} '
                                     f'{health}')
            out = os.path.join(work, f'out_{name}')
            req = {'out_dir': out}
            req.update({'scene_dirs': [scene, scene_b]} if 'batch' in kw
                       else {'scene_dir': scene})
            if not ese:
                req['train_shift'] = SERVE_SHIFT
            times = []
            for k in range(1 + SERVE_REQUESTS[ese]):
                status, resp, wall = _http(port, 'POST', '/infer', req)
                if status != 200:
                    raise AssertionError(f'serve {name}: request {k} gave '
                                         f'{status} {resp}')
                if k:
                    times.append((resp['runtime_s'], wall))
            n_ese += (1 + SERVE_REQUESTS[ese]) if ese else 0
            torch.cuda.synchronize()
            peak = torch.cuda.max_memory_allocated()
        finally:
            server.shutdown()
            server.server_close()
            thread.join(timeout=60)
        del engine
        gc.collect()
        torch.cuda.empty_cache()

        scenes = resp['scenes'] if 'batch' in kw else [resp]
        means = [pfm.load(os.path.join(
            out, s['scene'] if 'batch' in kw else '', 'result.pfm'))
            for s in scenes]
        for s, m in zip(scenes, means):
            if m.shape != (SIZE, SIZE) or not np.isfinite(m).all() or \
                    not math.isfinite(s['mse']):
                raise AssertionError(f'serve {name}: result.pfm {m.shape}, '
                                     f'mse {s["mse"]}')
        rt = statistics.median(r for r, _ in times)
        wall = statistics.median(w for _, w in times)
        host = statistics.median(w - r for r, w in times)
        results[name] = {'means': means, 'resp': scenes[0], 'runtime_s': rt,
                         'wall_s': wall, 'host_s': host, 'peak': peak}
        log(f'serve {name}: {len(blob) / 1e6:.1f} MB artifact exported in '
            f'{export_s:.2f} s; {len(times)} timed requests after one '
            f'warm-up: median runtime_s {rt:.4f} s, HTTP wall {wall:.4f} s, '
            f'host share (wall - runtime_s) {host:.4f} s; runtime_s '
            f'{[r for r, _ in times]}, wall {[round(w, 4) for _, w in times]};'
            f' peak device memory {peak / 2**30:.3f} GiB; card {card}')

    counts = read_launches(M)
    want = expected(M, laplace_mixture_posterior=n_ese)
    if counts != want:
        raise AssertionError(f'serve launched {counts}, expected {want}')

    ref = results['upr']['means'][0]
    diffs = {}
    for name in ('upr_u8', 'upr_b2', 'upr_tiled'):
        diffs[name] = max(float(np.abs(m - ref).max())
                          for m in results[name]['means'])
    diffs['ese'] = float(np.abs(results['ese']['means'][0]
                                - main_run['result']).max())
    bad = {k: v for k, v in diffs.items() if not v <= SERVE_TOL}
    if bad:
        raise AssertionError(f'serve: max |d mean| {bad} > {SERVE_TOL} '
                             f'(u8, batch-2, tiled against fp32; ESE '
                             f'against phase main)')
    rel = {}
    for key, main_key in (('mse', 'mse'), ('badpix_007', 'badpix')):
        want_v = main_run['metrics'][main_key]
        got_v = results['ese']['resp'][key]
        rel[key] = abs(got_v - want_v) / max(abs(want_v), 1e-30)
        if not rel[key] <= SERVE_REL:
            raise AssertionError(f'serve ese: {key} {got_v} against phase '
                                 f'main\'s {want_v} (rel {rel[key]:.2e} > '
                                 f'{SERVE_REL})')
    log('serve: max |d mean| ' + ', '.join(
        f'{k} {v:.3e}' for k, v in diffs.items())
        + f' (limit {SERVE_TOL}; u8 / batch-2 / tiled against fp32 at '
        f'train_shift {SERVE_SHIFT}, ESE against phase main at 0.0); ESE '
        f'mse / badpix_007 against phase main: rel '
        f'{rel["mse"]:.2e} / {rel["badpix_007"]:.2e} (limit {SERVE_REL}); '
        f'mixture posterior launches {counts["laplace_mixture_posterior"]} '
        f'for {n_ese} ESE requests')
    return {'launches': counts['laplace_mixture_posterior'],
            'results': results}


def phase_bf16_eval(M, run: str, val: str, card: str) -> dict:
    """ESE validate of the bf16 trunk run's checkpoint (its stored config
    has ``bf16``: the 70 members run the bf16 trunk on the BN-folded
    weights, K2 and the metrics stay fp32), K2 once; the same weights with
    ``bf16`` off, whose member means must lie within BF16_MEMBER_PX of the
    bf16 ones; then one UPR request served from the checkpoint's exported
    artifact over HTTP after one warm-up."""
    import threading
    import numpy as np
    import torch
    from mmlf_tpu_torch.export import export_inference
    from mmlf_tpu_torch.models.ensemble import ensemble_grid
    from mmlf_tpu_torch.serve import InferenceEngine, make_server
    from mmlf_tpu_torch.utils import pfm
    from mmlf_tpu_torch.validate import cli

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launches(M)
    t = time.time()
    result = cli.main([run, val, '--val_ensamble'], standalone_mode=False)
    torch.cuda.synchronize()
    wall = time.time() - t
    counts = read_launches(M)
    peak = torch.cuda.max_memory_allocated()
    for key in METRICS:
        if not math.isfinite(result[key]):
            raise AssertionError(f'bf16 metric {key} = {result[key]}')
    if counts != expected(M, laplace_mixture_posterior=1):
        raise AssertionError(f'bf16 ESE validate of 1 scene launched '
                             f'{counts}')
    gmm = np.load(os.path.join(run, 'scenes', 'scene_00', 'gmm.npy'))

    # the same weights evaluated in float32
    ref = os.path.join(os.path.dirname(run), 'run_bf16_as_fp32')
    os.makedirs(ref)
    ckpt = torch.load(os.path.join(run, 'checkpoint.pt'), map_location='cpu',
                      weights_only=True)
    if not ckpt['hyper_parameters']['bf16']:
        raise AssertionError('the bf16 run\'s checkpoint does not say bf16')
    ckpt['hyper_parameters'] = dict(ckpt['hyper_parameters'], bf16=False)
    torch.save(ckpt, os.path.join(ref, 'checkpoint.pt'))
    result32 = cli.main([ref, val, '--val_ensamble'], standalone_mode=False)
    gmm32 = np.load(os.path.join(ref, 'scenes', 'scene_00', 'gmm.npy'))
    shifts = ensemble_grid(-3.5, 3.5, 0.1)[:, None, None]
    diff = np.abs(gmm[0] - gmm32[0])
    max_d, rms_d = float(diff.max()), float(np.sqrt(np.mean(diff ** 2.0)))
    rms_net = float(np.sqrt(np.mean((gmm32[0] - shifts) ** 2.0)))
    if not max_d <= BF16_MEMBER_PX:
        raise AssertionError(f'bf16 members vs the same weights in fp32: '
                             f'max difference {max_d:.4e} px > '
                             f'{BF16_MEMBER_PX}')
    log(f'bf16_eval: ESE validate of the bf16 trunk checkpoint '
        f'{result["runtime"]:.3f} s/scene (CLI runtime), {wall:.3f} s CLI '
        f'wall, peak device memory {peak / 2**30:.3f} GiB, mixture '
        f'posterior launches {counts["laplace_mixture_posterior"]}; metrics '
        + json.dumps({k: result[k] for k in METRICS}) + '; the same weights '
        f'in fp32: {result32["runtime"]:.3f} s/scene, member means max / '
        f'RMS difference {max_d:.4e} / {rms_d:.4e} px (limit '
        f'{BF16_MEMBER_PX} px; RMS net output {rms_net:.4e}), metrics minus '
        f'the fp32 ones '
        + json.dumps({k: result[k] - result32[k] for k in METRICS}))
    gc.collect()
    torch.cuda.empty_cache()

    # one UPR request to the served artifact of the bf16 checkpoint
    work = os.path.join(os.path.dirname(run), 'serve_bf16')
    os.makedirs(work)
    blob = export_inference(run, SIZE, SIZE)
    art = os.path.join(work, 'upr_bf16.mmlft')
    with open(art, 'wb') as f:
        f.write(blob)
    reset_launches(M)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    engine = InferenceEngine(art)
    if engine.meta['dtype'] != 'bfloat16':
        raise AssertionError(f'artifact dtype {engine.meta["dtype"]}')
    server = make_server(engine, '127.0.0.1', 0)
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    out = os.path.join(work, 'out')
    req = {'scene_dir': os.path.join(val, 'scene_00'), 'out_dir': out,
           'train_shift': SERVE_SHIFT}
    try:
        port = server.server_address[1]
        answers = [_http(port, 'POST', '/infer', req) for _ in range(2)]
        torch.cuda.synchronize()
        serve_peak = torch.cuda.max_memory_allocated()
    finally:
        server.shutdown()
        server.server_close()
        thread.join(timeout=60)
    del engine
    for status, resp, _ in answers:
        if status != 200:
            raise AssertionError(f'bf16 serve: {status} {resp}')
    mean = pfm.load(os.path.join(out, 'result.pfm'))
    if mean.shape != (SIZE, SIZE) or not np.isfinite(mean).all():
        raise AssertionError(f'bf16 serve: result.pfm {mean.shape}')
    if read_launches(M) != expected(M):
        raise AssertionError(f'bf16 UPR request launched {read_launches(M)}')
    _, resp, http_wall = answers[1]
    log(f'bf16_serve: UPR request (train_shift {SERVE_SHIFT}) after one '
        f'warm-up: runtime_s {resp["runtime_s"]:.4f} s, HTTP wall '
        f'{http_wall:.4f} s, mse {resp["mse"]:.4f}, peak device memory '
        f'{serve_peak / 2**30:.3f} GiB; card {card}')
    return {'launches': counts['laplace_mixture_posterior'],
            's_per_scene': result['runtime'], 'peak_bytes': peak}


def phase_member_time() -> None:
    """Device time of one warm full-width ESE member (shift + forward) at
    the whole 512² scene and at one 310² ``--val_tile 256`` window, for the
    breakdown of the ESE time."""
    import torch
    from mmlf_tpu_torch.config import Config
    from mmlf_tpu_torch.models.feed_forward import FeedForward, init_live_
    from mmlf_tpu_torch.ops.shift import shift_lf

    cfg = Config(val_ensamble=True, model_no_batchnorm=True).finalize()
    model = init_live_(FeedForward.from_config(cfg), seed=1).cuda().eval()
    gen = torch.Generator(device='cuda').manual_seed(0)
    for size, members in ((SIZE, 70), (VAL_WINDOW, 4 * 70)):
        stacks = [torch.rand((1, 9, size, size, 3), generator=gen,
                             device='cuda') for _ in range(4)]
        with torch.no_grad():
            fwd_ms = cuda_ms(lambda: model(*stacks), reps=3)
            shift_ms = cuda_ms(lambda: shift_lf(*stacks, 1.3), reps=10)
        flop = size * size * conv_flop_per_pixel()
        log(f'member at {size}²: forward {fwd_ms:.2f} ms '
            f'({flop / fwd_ms / 1e9:.1f} TFLOP/s fp32 on {flop / 1e12:.3f} '
            f'TFLOP), shift {shift_ms:.3f} ms; x{members} members = '
            f'{members * (fwd_ms + shift_ms) / 1e3:.2f} s')


def phase_breakdown(run: str, val: str, host: dict) -> None:
    """Host-clock times of the validate path's pieces outside the member
    forwards, on the main path's scene and member dumps; the texture mask
    runs in the host library (phase host timed the numpy fallback)."""
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
        f'{t_tex:.3f} s of it, native; the numpy fallback '
        f'{host["mask_numpy_s"]:.3f} s in phase host), calibration guard '
        f'{t_cal:.3f} s, ESE KLD discretization {t_lmm:.3f} s, member dumps '
        f'to host {t_d2h:.3f} s')


def phase_bf16(M, train: str, val: str, work: str, card: str) -> dict:
    """The bf16 phases: train_bf16 (the recipe with ``--bf16
    --cache_bf16``: cuDNN's bf16 convs, K1 on bf16 image windows), K1's
    bf16 instance at the recipe shape, train_bf16_trunk (the same with
    ``--pallas_trunk``: K3's bf16 instance) and K3's bf16 card check.
    Returns the kernels-line numbers and the trunk run's directory."""
    import torch
    train_run = phase_train(M, train, val, os.path.join(work, 'run_bf16'),
                            TRAIN_STEPS, bf16=True)
    gather = phase_window_gather(M.W, train_run['pipeline'],
                                 train_run['size'])
    k1 = train_run['launches']['window_gather_bf16']
    s_plain, peak_plain = train_run['s_step'], train_run['peak']
    del train_run
    gc.collect()
    torch.cuda.empty_cache()
    run = os.path.join(work, 'run_bf16_trunk')
    trunk_run = phase_train(M, train, val, run, TRUNK_STEPS, trunk=True,
                            bf16=True)
    k1 += trunk_run['launches']['window_gather_bf16']
    k3_launches = {kind: trunk_run['launches'][f'fused_double_conv_{kind}'
                                               f'_bf16']
                   for kind in ('fwd', 'bwd')}
    trunk_s, trunk_peak = trunk_run['s_step'], trunk_run['peak']
    del trunk_run
    gc.collect()
    torch.cuda.empty_cache()
    k3 = phase_conv_block(M, bf16=True)
    accum = int(RECIPE[RECIPE.index('--train_accum') + 1])
    log(f'bf16 steps: --bf16 --cache_bf16 {s_plain:.3f} s/step, '
        f'{peak_plain / 2**30:.2f} GiB; with --pallas_trunk {trunk_s:.3f} '
        f's/step, {trunk_peak / 2**30:.2f} GiB, of it K3 bf16 fwd '
        f'{accum * k3["fwd"]["ms"] / 1e3 / trunk_s:.2%}, bwd '
        f'{accum * k3["bwd"]["ms"] / 1e3 / trunk_s:.2%}; card {card}')
    torch.cuda.empty_cache()
    return {'gather': gather, 'k1_launches': k1, 'k3': k3,
            'k3_launches': k3_launches, 'run': run}


def recipe_config(train: str):
    """The Config the train CLI builds from RECIPE on ``train``."""
    from mmlf_tpu_torch.config import Config
    from mmlf_tpu_torch.train import cli
    params = cli.main.make_context('train', [train, *RECIPE]).params
    del params['output_dir'], params['device']
    return Config.from_dict(params).finalize()


def phase_host(train: str, val: str, card: str) -> dict:
    """The host runtime: the port's host library built with g++ and loaded
    (a build failure raises with g++'s output); the val scene's texture
    mask, native against the numpy fallback (equal), both timed;
    ``strided_window`` against numpy slicing at f = 1..4 on a recipe scene
    (equal); the host sampler's ms per batch of 512 at the recipe, with
    the default workers and with ``--train_num_workers 0``, and the batch's
    copy to the card from pinned memory."""
    import numpy as np
    import torch
    from mmlf_tpu_torch import native
    from mmlf_tpu_torch.data.hci4d import HCI4D
    from mmlf_tpu_torch.data.pipeline import TrainPipeline, batch_to_device
    from mmlf_tpu_torch.ops.masks import create_mask_texture

    native.reset()
    t = time.time()
    path = native.build()
    build_s = time.time() - t
    if native.get_lib() is None or native.loaded_path() != path or \
            os.path.commonpath([str(path), os.path.join(REPO, 'build')]) \
            != os.path.join(REPO, 'build'):
        raise AssertionError(f'host library not loaded from build/: '
                             f'{native.loaded_path()}')
    log(f'host: library {os.path.relpath(str(path), REPO)} built and '
        f'loaded in {build_s:.1f} s (g++ {" ".join(native.CXX_FLAGS)})')

    center = HCI4D(val)[0][4]
    t = time.perf_counter()
    mask_native = create_mask_texture(center)
    native_s = time.perf_counter() - t
    os.environ[native.DISABLE_ENV] = '1'
    native.reset()
    try:
        t = time.perf_counter()
        mask_numpy = create_mask_texture(center)
        numpy_s = time.perf_counter() - t
    finally:
        del os.environ[native.DISABLE_ENV]
        native.reset()
    if native.get_lib() is None:
        raise AssertionError('host library not reloaded')
    if not np.array_equal(mask_native, mask_numpy):
        raise AssertionError(f'texture mask: native and numpy differ at '
                             f'{int((mask_native != mask_numpy).sum())} '
                             f'pixels')
    log(f'host: texture mask of the {center.shape[0]}x{center.shape[1]} val '
        f'scene: native {native_s:.3f} s, numpy {numpy_s:.3f} s, equal '
        f'({int(mask_native.sum())} textured pixels); {os.cpu_count()} '
        f'host cores')

    cfg = recipe_config(train)
    pipe = TrainPipeline(HCI4D(train, cache=True), cfg, seed=0)
    rng = np.random.default_rng(0)
    src = pipe.scenes[0]['h']
    for f in range(1, 5):
        hf, wf = -(-src.shape[1] // f), -(-src.shape[2] // f)
        for _ in range(4):
            y, x = rng.integers(0, hf - pipe.win + 1), \
                rng.integers(0, wf - pipe.win + 1)
            got = native.strided_window(src, y, x, f, pipe.win)
            want = src[:, ::f, ::f][:, y:y + pipe.win, x:x + pipe.win]
            if not np.array_equal(got, want):
                raise AssertionError(f'strided_window differs at f={f}, '
                                     f'({y}, {x})')
    log(f'host: strided_window equals numpy slicing at f = 1..4 '
        f'(window {pipe.win} of a {src.shape} stack, 4 starts each)')

    bs = cfg.train_bs
    res = {}
    # the first batch with workers also allocates the pinned buffers; the
    # cutter in the loop's thread takes ~4x as long, so one batch of it
    for workers, reps in ((cfg.train_num_workers, 3), (0, 1)):
        pipe.cfg = cfg.__class__.from_dict({**cfg.to_dict(),
                                            'train_num_workers': workers})
        times, copies = [], []
        for _ in range(reps):
            t = time.perf_counter()
            batch = pipe.sample_batch(bs, pin_memory=True)
            times.append(time.perf_counter() - t)
            torch.cuda.synchronize()
            t = time.perf_counter()
            dev = batch_to_device(batch, 'cuda', with_mpi=False)
            torch.cuda.synchronize()
            copies.append(time.perf_counter() - t)
            n_bytes = sum(x.numel() * x.element_size() for x in dev[:-1]
                          if x is not None)
            del dev, batch
        res[workers] = (times, copies)
        log(f'host: sampler at the recipe (bs {bs}, ps {cfg.train_ps}, '
            f'window {pipe.win}, f 1..{pipe.max_f}) with {workers} workers: '
            f'{[round(x * 1e3, 1) for x in times]} ms per batch; its copy '
            f'to the card from pinned memory ({n_bytes / 1e9:.2f} GB, MPI '
            f'left out) {[round(x * 1e3, 1) for x in copies]} ms '
            f'({n_bytes / min(copies) / 1e9:.1f} GB/s); card {card}')
    pipe.close()
    return {'mask_native_s': native_s, 'mask_numpy_s': numpy_s,
            'sampler': res}


def phase_train_host(M, train: str, val: str, work: str, card: str) -> dict:
    """The recipe with ``--host_pipeline --bf16 --pallas_trunk``: the
    windows cut on the host and augmented on the card, K3's bf16 instance
    forward and backward 20 x accum x steps times each, K1 never; then the
    run's first host batch against the batch the same seed gives with
    native code disabled (equal, bit for bit)."""
    import numpy as np
    from mmlf_tpu_torch import native
    from mmlf_tpu_torch.config import Config
    from mmlf_tpu_torch.data.hci4d import HCI4D
    from mmlf_tpu_torch.data.pipeline import TrainPipeline

    run = phase_train(M, train, val, os.path.join(work, 'run_host'),
                      TRAIN_STEPS, trunk=True, bf16=True, host=True)
    first = run.pop('first')
    cfg = Config.from_dict(run['hyper'])
    os.environ[native.DISABLE_ENV] = '1'
    native.reset()
    try:
        pipe = TrainPipeline(HCI4D(train, cache=True), cfg,
                             seed=cfg.train_seed)
        want = pipe.sample_batch(cfg.train_bs)
        pipe.close()
    finally:
        del os.environ[native.DISABLE_ENV]
        native.reset()
    for k in want._fields[:-1]:
        if not np.array_equal(getattr(first, k), getattr(want, k)):
            raise AssertionError(f'train_host: first batch field {k} '
                                 f'differs from the numpy cutter\'s')
    for k in want.aug._fields:
        if not np.array_equal(getattr(first.aug, k), getattr(want.aug, k)):
            raise AssertionError(f'train_host: first batch aug.{k} differs')
    del first, want
    sample_ms = 1e3 * sum(run['sample_s'][1:]) / len(run['sample_s'][1:])
    copy_ms = 1e3 * sum(run['copy_s'][1:]) / len(run['copy_s'][1:])
    log(f'train_host: first host batch equals the numpy cutter\'s bit for '
        f'bit; steady {run["s_step"]:.3f} s/step, sampler {sample_ms:.1f} '
        f'ms and copy {copy_ms:.1f} ms per batch, peak device memory '
        f'{run["peak"] / 2**30:.2f} GiB; card {card}')
    gc.collect()
    return {'launches': run['launches'], 's_step': run['s_step'],
            'sample_ms': sample_ms, 'copy_ms': copy_ms, 'peak': run['peak']}


def phase_unet(M, train: str, val: str, work: str, card: str) -> dict:
    """The recipe with ``--model_unet`` (fp32, K1 accum x steps times),
    then ESE validation of its checkpoint through the validate CLI (whole
    scene, K2 once), and one exported UPR artifact served over HTTP after
    one warm-up, its mean against the direct eval forward's (SERVE_TOL)."""
    import threading
    import numpy as np
    import torch
    from mmlf_tpu_torch.config import Config
    from mmlf_tpu_torch.data.hci4d import HCI4D
    from mmlf_tpu_torch.export import export_inference
    from mmlf_tpu_torch.models.feed_forward import FeedForward
    from mmlf_tpu_torch.serve import InferenceEngine, make_server
    from mmlf_tpu_torch.utils import pfm
    from mmlf_tpu_torch.validate import cli
    from mmlf_tpu_torch.validate.cli import load_model_state, scene_to_device

    run = os.path.join(work, 'run_unet')
    trained = phase_train(M, train, val, run, UNET_STEPS, unet=True)
    k1 = trained['launches']['window_gather']
    s_step, train_peak = trained['s_step'], trained['peak']
    del trained
    gc.collect()
    torch.cuda.empty_cache()

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_launches(M)
    t = time.time()
    result = cli.main([run, val, '--val_ensamble'], standalone_mode=False)
    torch.cuda.synchronize()
    wall = time.time() - t
    counts = read_launches(M)
    val_peak = torch.cuda.max_memory_allocated()
    for key in METRICS:
        if not math.isfinite(result[key]):
            raise AssertionError(f'unet metric {key} = {result[key]}')
    if counts != expected(M, laplace_mixture_posterior=1):
        raise AssertionError(f'unet ESE validate launched {counts}')
    gmm = np.load(os.path.join(run, 'scenes', 'scene_00', 'gmm.npy'))
    if gmm.shape != (2, 70, SIZE, SIZE) or not np.isfinite(gmm).all():
        raise AssertionError(f'unet gmm.npy {gmm.shape}')
    log(f'unet: ESE validate {result["runtime"]:.3f} s/scene (CLI runtime), '
        f'{wall:.3f} s CLI wall, peak device memory {val_peak / 2**30:.3f} '
        f'GiB, mixture posterior launches '
        f'{counts["laplace_mixture_posterior"]}; metrics '
        + json.dumps({k: result[k] for k in METRICS}))

    # the direct eval forward of the checkpoint on the val scene
    state, hyper = load_model_state(run)
    model = FeedForward.from_config(Config.from_dict(hyper))
    model.load_state_dict(state, strict=True)
    model.cuda().eval()
    stacks, _, _ = scene_to_device(HCI4D(val)[0], torch.device('cuda'))
    with torch.no_grad():
        direct = model(*stacks)['mean'][0].cpu().numpy()
    del model, stacks
    gc.collect()
    torch.cuda.empty_cache()

    serve_dir = os.path.join(work, 'serve_unet')
    os.makedirs(serve_dir)
    art = os.path.join(serve_dir, 'upr_unet.mmlft')
    with open(art, 'wb') as f:
        f.write(export_inference(run, SIZE, SIZE))
    reset_launches(M)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    engine = InferenceEngine(art)
    server = make_server(engine, '127.0.0.1', 0)
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    out = os.path.join(serve_dir, 'out')
    req = {'scene_dir': os.path.join(val, 'scene_00'), 'out_dir': out}
    try:
        port = server.server_address[1]
        answers = [_http(port, 'POST', '/infer', req) for _ in range(2)]
        torch.cuda.synchronize()
        serve_peak = torch.cuda.max_memory_allocated()
    finally:
        server.shutdown()
        server.server_close()
        thread.join(timeout=60)
    del engine
    for status, resp, _ in answers:
        if status != 200:
            raise AssertionError(f'unet serve: {status} {resp}')
    if read_launches(M) != expected(M):
        raise AssertionError(f'unet UPR request launched {read_launches(M)}')
    # result.pfm holds the mean flipped upside down (the reference's layout)
    mean = np.flip(pfm.load(os.path.join(out, 'result.pfm')), 0)
    diff = float(np.abs(mean - direct).max())
    if mean.shape != (SIZE, SIZE) or not diff <= SERVE_TOL:
        raise AssertionError(f'unet serve: result.pfm {mean.shape}, max '
                             f'|d mean| against the direct forward {diff}')
    _, resp, http_wall = answers[1]
    log(f'unet_serve: UPR request after one warm-up: runtime_s '
        f'{resp["runtime_s"]:.4f} s, HTTP wall {http_wall:.4f} s, max |d '
        f'mean| against the direct eval forward {diff:.3e} (limit '
        f'{SERVE_TOL}), peak device memory {serve_peak / 2**30:.3f} GiB; '
        f'U-Net train {s_step:.3f} s/step, {train_peak / 2**30:.2f} GiB; '
        f'card {card}')
    gc.collect()
    torch.cuda.empty_cache()
    return {'k1_launches': k1, 'k2_launches': counts[
        'laplace_mixture_posterior'], 's_step': s_step,
        's_per_scene': result['runtime'], 'runtime_s': resp['runtime_s']}


def probe_block_bound(b, h, w, c, n_blocks, peak, eb, m):
    """Least time of ``n_blocks`` chained fused blocks of the probe:
    operations by the script's count (conv 1 over H×W, not (H+1)×(W+1):
    ``n·2·B·H·W·4·C²·2``) at ``peak``, against bytes (the input canvas
    read once, the y1 and y2 canvases of the last block written once,
    ``eb`` bytes an element, and the weights)."""
    ops = n_blocks * 2 * b * h * w * 4 * c * c * 2
    n_bytes = eb * (3 * b * c * m + n_blocks * 8 * c * c) + \
        4 * n_blocks * 2 * c
    t_ops, t_bytes = ops / peak, n_bytes / PEAK_BYTES
    return (max(t_ops, t_bytes) * 1e3,
            'operations' if t_ops >= t_bytes else 'bytes')


def phase_probes(M, card: str) -> list:
    """The probe scripts' kernels (``mmlf_tpu_torch/probes``), each path
    read with the counts set to 0 just before it: the fused block's
    ``check`` (fp32, B 2, 13×17, C 24, 2 blocks, K3's fp32 instance) and one
    such block against a float64 evaluation (within K3_PREC_FACTOR x the
    fp32 plain version's error) and timed; ``bench`` (bf16, B 64, 96², C 280
    and 256, 7 blocks: the chain through K3's bf16 instance, with and
    without the canvas transposes, through its plain version and cuDNN's
    direct chain), then the first block of each C held as
    ``k3_bf16_check``; the window copies of probe3 (27 channels, 4-byte
    words) and probe4 (128 channels, 16-byte words and the two-slot ring),
    each equal to the indexed windows bit for bit, timed beside the plain
    copy and one advanced-indexing call.  Returns the kernels-line
    entries."""
    import numpy as np
    import torch
    from mmlf_tpu_torch.probes import block_probe as BP
    from mmlf_tpu_torch.probes import gather_probe as GP

    entries = []
    t0 = time.time()
    # --- fused block, fp32, the script's check
    reset_launches(M)
    BP.check('cuda')
    torch.cuda.synchronize()
    launches = read_launches(M)
    if launches != expected(M, fused_block_fwd=2):
        raise AssertionError(f'probe check launches {launches}')
    h, w, c, b = 13, 17, 24, 2
    rng = np.random.default_rng(0)
    p = BP.make_params(rng, 1, c, torch.float32, 'cuda')[0]
    x = torch.as_tensor(rng.standard_normal((b, h, w, c)) * 0.5,
                        dtype=torch.float32, device='cuda')
    m = BP.canvas_dims(h, w)[3]
    xc = BP.to_canvas(x, m)
    got = BP.defined(*BP.fused_block(xc, *p, h, w), h, w)
    plain = BP.defined(*BP.plain_fused_block(xc, *p, h, w), h, w)
    ref = BP.defined(*BP.block_on_canvas(
        M.C.plain_fused_block, xc, *(a.double() for a in p), h, w), h, w)
    torch.cuda.synchronize()
    err = 0.0
    for name, g, pl_, r in zip(('y1', 'y2'), got, plain, ref):
        e_k = float((g.double() - r.double()).abs().max())
        e_p = float((pl_.double() - r.double()).abs().max())
        floor = 2.0 ** -24 * float(r.abs().max())
        if e_k > K3_PREC_FACTOR * max(e_p, floor):
            raise AssertionError(f'probe fused block fp32 {name}: error vs '
                                 f'float64 {e_k:.3e} > {K3_PREC_FACTOR} x '
                                 f'the fp32 plain version\'s {e_p:.3e}')
        err = max(err, e_k)
    ms = cuda_ms(lambda: BP.fused_block(xc, *p, h, w), reps=20)
    plain_ms = cuda_ms(lambda: BP.plain_fused_block(xc, *p, h, w), reps=20)
    library_ms = cuda_ms(lambda: BP.direct_block(x, *p), reps=20)
    bound_ms, by = probe_block_bound(b, h, w, c, 1, PEAK_3XTF32, 4, m)
    log(f'probe fused block fp32 B={b} {h}x{w} C={c}: max abs err vs '
        f'float64 {err:.2e}; {ms:.4f} ms (canvas in, canvases out), plain '
        f'{plain_ms:.4f} ms, cuDNN direct block {library_ms:.4f} ms, bound '
        f'{bound_ms:.5f} ms ({by}); launch-bound at this size')
    entries.append({
        'name': 'fused_block_fwd', 'route': 'cuda',
        'source': 'mmlf_tpu_torch/csrc/conv_block.cu',
        'replaces': 'scripts/pallas_block_probe.py:118',
        'launches': launches['fused_block_fwd'], 'max_abs_err': err,
        'ms': ms, 'plain_ms': plain_ms, 'bound_ms': bound_ms,
        'bound_by': by, 'library_ms': library_ms})

    # --- fused block, bf16, the script's bench
    reset_launches(M)
    bench = BP.bench('cuda', reps=PROBE_REPS)
    torch.cuda.synchronize()
    launches = read_launches(M)
    # per C: the resident chain and the chain with transposes, each one
    # warm-up and PROBE_REPS calls of BENCH_BLOCKS blocks
    n = len(BP.BENCH) * 2 * BP.BENCH_BLOCKS * (PROBE_REPS + 1)
    if launches != expected(M, fused_block_fwd_bf16=n):
        raise AssertionError(f'probe bench launches {launches}, expected '
                             f'{n} of fused_block_fwd_bf16')
    errs = []
    h = w = BP.BENCH_HW
    for c, b in BP.BENCH:
        rng = np.random.default_rng(c)
        p = BP.make_params(rng, 1, c, torch.bfloat16, 'cuda')[0]
        x = torch.as_tensor(rng.standard_normal((b, h, w, c)) * 0.3,
                            dtype=torch.bfloat16, device='cuda')
        m = BP.canvas_dims(h, w)[3]
        xc = BP.to_canvas(x, m)
        got = BP.defined(*BP.fused_block(xc, *p, h, w), h, w)
        plain = BP.defined(*BP.plain_fused_block(xc, *p, h, w), h, w)
        ref = BP.defined(*BP.block_on_canvas(
            M.C.plain_fused_block, xc, *(a.double() for a in p), h, w), h, w)
        torch.cuda.synchronize()
        errs += [k3_bf16_check(g, pl_, r, f'probe fused block bf16 C={c} '
                               f'{name}')
                 for name, g, pl_, r in zip(('y1', 'y2'), got, plain, ref)]
        del got, plain, ref, xc, x
        torch.cuda.empty_cache()
    r0 = bench[0]
    by = probe_block_bound(r0['b'], h, w, r0['c'], BP.BENCH_BLOCKS,
                           PEAK_BF16, 2, BP.canvas_dims(h, w)[3])
    for r in bench:
        log(f'probe bench C={r["c"]} B={r["b"]} {BP.BENCH_BLOCKS} blocks '
            f'bf16: K3 chain {r["ms"]:.3f} ms ({r["e2e_ms"]:.3f} with the '
            f'canvas transposes), plain {r["plain_ms"]:.3f} ms, cuDNN '
            f'direct chain {r["library_ms"]:.3f} ms, bound '
            f'{r["bound_ms"]:.3f} ms ({r["flop"] / 1e12:.2f} TFLOP at '
            f'{PEAK_BF16 / 1e12:.0f} TFLOP/s), '
            f'{r["bound_ms"] / r["ms"]:.1%} of it; card {card}')
    entries.append({
        'name': 'fused_block_fwd_bf16', 'route': 'cuda',
        'source': 'mmlf_tpu_torch/csrc/conv_block.cu',
        'replaces': 'scripts/pallas_block_probe.py:118',
        'launches': launches['fused_block_fwd_bf16'],
        'max_abs_err': max(errs),
        # the C 280 chain of BENCH_BLOCKS blocks
        'ms': r0['ms'], 'plain_ms': r0['plain_ms'],
        'bound_ms': r0['bound_ms'], 'bound_by': by[1],
        'library_ms': r0['library_ms']})

    # --- window copies
    for probe, line, names in (
            ('probe3', 'scripts/gather_probe3.py:70',
             (('pallas_gather', 'window_copy', 'window_copy_probe3'),)),
            ('probe4', 'scripts/gather_probe4.py:55',
             (('pallas_gather', 'window_copy', 'window_copy_probe4'),
              ('pallas_gather2', 'window_copy_ring',
               'window_copy_ring_probe4')))):
        reset_launches(M)
        out = GP.run(probe, 'cuda', reps=20)
        torch.cuda.synchronize()
        launches = read_launches(M)
        # the check, the warm-up and 20 timed calls of each copy
        want = expected(M, **{counter: 22 for _, counter, _ in names})
        if launches != want:
            raise AssertionError(f'{probe} launches {launches}, expected '
                                 f'{want}')
        for fn, counter, name in names:
            entries.append({
                'name': name, 'route': 'cuda',
                'source': 'mmlf_tpu_torch/csrc/window_gather.cu',
                'replaces': line if fn == 'pallas_gather'
                else 'scripts/gather_probe4.py:88',
                'launches': launches[counter],
                'max_abs_err': out[fn]['max_abs_err'],
                'ms': out[fn]['ms'], 'plain_ms': out['plain_ms'],
                'bound_ms': out['bound_ms'], 'bound_by': 'bytes',
                'library_ms': out['library_ms']})
            log(f'{name}: {out[fn]["ms"]:.4f} ms, plain '
                f'{out["plain_ms"]:.4f} ms, advanced indexing '
                f'{out["library_ms"]:.4f} ms, bound {out["bound_ms"]:.4f} ms '
                f'({out["bytes"] / 1e9:.3f} GB read + written), '
                f'{out["bound_ms"] / out[fn]["ms"]:.1%} of it; card {card}')
    log(f'probes: {time.time() - t0:.1f} s')
    return entries


def _bn_stats(run: str) -> dict:
    import torch
    sd = torch.load(os.path.join(run, 'checkpoint.pt'), map_location='cpu',
                    weights_only=True)['model_state_dict']
    return {k: v for k, v in sd.items()
            if k.endswith(('running_mean', 'running_var'))}


def _log_rows(run: str) -> list:
    return [[float(v) for v in line.split(',')] for line in
            open(os.path.join(run, 'log.csv')).read().splitlines()[1:]]


def phase_dp(M, train: str, val: str, work: str, card: str,
             n_ranks: int = DP_RANKS, backend='gloo') -> dict:
    """Data parallel through the library API: the recipe with
    ``--pallas_trunk --mesh_data n_ranks`` for DP_STEPS steps at full
    width, on gloo ranks that share this card (``train_ranks``; NCCL
    refuses two ranks on one device), or with ``backend=None`` through
    ``train``'s own path, one NCCL rank a card; each rank counts its own
    launches (K1 accum x steps, K3 TRUNK_BLOCKS x accum x steps each way
    on its share of every microbatch) and reports them.  Then the same
    recipe on one rank from the same seed: the log's losses within
    DP_LOSS_REL and every BN running statistic within DP_STATS_REL (of
    itself and of its leaf's max).  With ranks sharing one card, s/step is
    no scaling number."""
    import numpy as np
    import torch
    from mmlf_tpu_torch.config import Config
    from mmlf_tpu_torch.train import cli, loop

    accum = int(RECIPE[RECIPE.index('--train_accum') + 1])
    runs = {}
    for n in (n_ranks, 1):
        run = os.path.join(work, f'run_dp{n}')
        os.makedirs(run)
        args = [run, '--train_trainset', train, '--train_valset', val,
                *RECIPE, '--train_steps', str(DP_STEPS), '--train_nan_guard',
                '--pallas_trunk', '--mesh_data', str(n)]
        params = cli.main.make_context('train', args).params
        del params['output_dir'], params['device']
        cfg = Config.from_dict(params).finalize()
        gc.collect()
        torch.cuda.empty_cache()
        reset_launches(M)
        t = time.time()
        if n > 1 and backend is None:
            state = loop.train(cfg, run, progress=False, device='cuda')
            if state.ranks is None:
                raise AssertionError(f'--mesh_data {n} fell back to one '
                                     f'device')
        elif n > 1:
            state = loop.train_ranks(cfg, run, n, device='cuda',
                                     backend=backend, progress=False,
                                     timeout=900)
        if n > 1:
            if read_launches(M) != expected(M):
                raise AssertionError('the parent launched kernels itself')
            launches = {k: sum(r['launches'][k] for r in state.ranks)
                        for k in counters(M)}
        else:
            state = loop.train(cfg, run, progress=False, device='cuda')
            launches = read_launches(M)
        torch.cuda.synchronize()
        wall = time.time() - t
        k3 = TRUNK_BLOCKS * accum * DP_STEPS * n
        want = expected(M, window_gather=accum * DP_STEPS * n,
                        fused_double_conv_fwd=k3, fused_double_conv_bwd=k3)
        if launches != want or state.step != DP_STEPS:
            raise AssertionError(f'dp {n} rank(s): launches {launches}, '
                                 f'expected {want}; step {state.step}')
        rows = _log_rows(run)
        if [int(r[0]) for r in rows] != list(range(DP_STEPS)) or \
                not np.isfinite(np.array(rows)).all():
            raise AssertionError(f'dp {n} rank(s): log rows {rows}')
        runs[n] = {'rows': rows, 'stats': _bn_stats(run), 'wall': wall,
                   'launches': launches, 's_step': rows[-1][5]}
        del state
    dp, one = runs[n_ranks], runs[1]
    loss_dp = np.array([r[1] for r in dp['rows']])
    loss_one = np.array([r[1] for r in one['rows']])
    loss_rel = float(np.abs(loss_dp - loss_one).max() / np.abs(loss_one).max())
    if loss_rel > DP_LOSS_REL:
        raise AssertionError(f'dp losses {loss_dp} vs one rank {loss_one}')
    stats_rel = 0.0
    for k, want in one['stats'].items():
        got = dp['stats'][k]
        d = float((got - want).abs().max())
        if not torch.allclose(got, want, rtol=DP_STATS_REL,
                              atol=DP_STATS_REL * float(want.abs().max())):
            raise AssertionError(f'dp BN statistic {k}: max diff {d:.3e}')
        stats_rel = max(stats_rel, d / float(want.abs().max()))
    how = (f'{n_ranks} gloo ranks sharing one card' if backend else
           f'{n_ranks} NCCL ranks, one a card')
    scaling = ('not a scaling number: the ranks share the card' if backend
               else f'{one["s_step"] / dp["s_step"]:.2f}x one card\'s')
    log(f'dp: the recipe with --pallas_trunk on {how}, {DP_STEPS} steps in '
        f'{dp["wall"]:.1f} s wall (spawn, data, cache and validation '
        f'included), step 1 {dp["s_step"]:.3f} s ({scaling}); one rank '
        f'{one["s_step"]:.3f} s/step; losses {loss_dp} vs {loss_one} (max '
        f'rel {loss_rel:.2e}), BN running statistics max diff '
        f'{stats_rel:.2e} of their leaf max; ranks\' launches '
        f'{ {k: v for k, v in dp["launches"].items() if v} }; card {card}')
    return {'launches': dp['launches'], 'one_launches': one['launches'],
            's_step': dp['s_step']}

def phase_mesh_val(M, run: str, val: str, work: str, whole: dict,
                   card: str) -> dict:
    """The train phase's checkpoint validated with ``--val_ensamble
    --mesh_ensemble 2`` and ``--val_ensamble --mesh_space 2`` through the
    library entry (``run_validation_ranks``) on MESH_RANKS gloo ranks that
    share the card.  Each rank counts its K2 launches: one per scene
    (``--mesh_ensemble``: on the gathered members; ``--mesh_space``: on its
    own rows), none in this process.  The member stacks, the posterior,
    the result and the metrics are held against phase main's whole-scene
    run (``whole``) within MESH_TOL / MESH_REL: the ranks run other conv
    shapes (a slab) or the same ones in another process, and cuDNN may
    pick other algorithms.  s/scene is printed, but two ranks on one card
    give no scaling number."""
    import numpy as np
    import torch
    from mmlf_tpu_torch.utils import pfm
    from mmlf_tpu_torch.validate.cli import run_validation_ranks

    out = {'launches': 0}
    for flag in ('mesh_ensemble', 'mesh_space'):
        d = os.path.join(work, f'run_{flag}')
        os.makedirs(d)
        shutil.copy(os.path.join(run, 'checkpoint.pt'), d)
        gc.collect()
        torch.cuda.empty_cache()
        reset_launches(M)
        t = time.time()
        result = run_validation_ranks(d, val, MESH_RANKS, device='cuda',
                                      backend='gloo', timeout=900,
                                      val_ensamble=True, **{flag: 2})
        wall = time.time() - t
        if read_launches(M) != expected(M):
            raise AssertionError(f'{flag}: the parent launched kernels')
        for r in result['ranks']:
            if r['launches'] != expected(M, laplace_mixture_posterior=1):
                raise AssertionError(f'{flag}: rank {r["rank"]} launched '
                                     f'{r["launches"]}, expected K2 once')
        out['launches'] += sum(r['launches']['laplace_mixture_posterior']
                               for r in result['ranks'])
        scene = os.path.join(d, 'scenes', 'scene_00')
        gmm = np.load(os.path.join(scene, 'gmm.npy'))
        post = np.load(os.path.join(scene, 'posterior.npy'))
        mean = pfm.load(os.path.join(scene, 'result.pfm'))
        if gmm.shape != whole['gmm'].shape or \
                post.shape != whole['posterior'].shape:
            raise AssertionError(f'{flag}: gmm.npy {gmm.shape}, '
                                 f'posterior.npy {post.shape}')
        diffs = {
            'means': float(np.abs(gmm[0] - whole['gmm'][0]).max()),
            'logvars': float(np.abs(np.log(gmm[1])
                                    - np.log(whole['gmm'][1])).max()),
            'posterior': float(np.abs(post - whole['posterior']).max()
                               / np.abs(whole['posterior']).max()),
            'mean (selected)': float((np.abs(mean - whole['result'])
                                      > MESH_TOL).mean()),
            'metrics': max(abs(result[k] - whole['metrics'][k])
                           / max(abs(whole['metrics'][k]), 1e-12)
                           for k in METRICS)}
        limits = {'means': MESH_TOL, 'logvars': MESH_TOL,
                  'posterior': MESH_REL, 'mean (selected)': 1e-3,
                  'metrics': MESH_REL}
        bad = {k: v for k, v in diffs.items() if not v <= limits[k]}
        if bad:
            raise AssertionError(f'{flag} vs the whole-scene run: {bad} '
                                 f'(limits {limits})')
        out[flag] = result['runtime']
        log(f'mesh_val: --val_ensamble --{flag} 2 on {MESH_RANKS} gloo ranks '
            f'sharing one card: {result["runtime"]:.3f} s/scene (rank 0\'s '
            f'CLI runtime; not a scaling number: the ranks share the card), '
            f'{wall:.1f} s wall (spawn and load included); K2 once a rank; '
            f'against phase main\'s whole-scene run: '
            + ', '.join(f'{k} {v:.3e}' for k, v in diffs.items())
            + f' (max |d| of members in disparity and log units, posterior '
            f'relative to its max, share of pixels whose result moved more '
            f'than {MESH_TOL}, largest relative metric difference); metrics '
            + json.dumps({k: result[k] for k in METRICS}) + f'; card {card}')
    return out


def inn_breakdown(run: str) -> None:
    """Device time of one full-width INN microbatch (64 windows of 96²,
    the run's weights in train mode, forward + IB loss + backward) by
    CUDA kernel (``profile_rows``), grouped into convolutions and GEMMs
    (cuDNN, cuBLAS and CUTLASS kernels) and everything else."""
    import torch
    from mmlf_tpu_torch.config import Config
    from mmlf_tpu_torch.losses import information_bottleneck
    from mmlf_tpu_torch.models import build_model
    from mmlf_tpu_torch.ops.codecs import reg_to_class
    from mmlf_tpu_torch.validate.cli import load_model_state

    state, hyper = load_model_state(run)
    cfg = Config.from_dict(hyper)
    model = build_model(cfg)
    model.load_state_dict(state, strict=True)
    model.cuda().train()
    gen = torch.Generator(device='cuda').manual_seed(0)
    stacks = [torch.rand(64, 27, 96, 96, device='cuda', generator=gen)
              for _ in range(4)]
    target = reg_to_class(torch.rand(64, 96, 96, device='cuda',
                                     generator=gen) * 7.0 - 3.5,
                          -3.5, 3.5, cfg.steps)

    def step():
        model.zero_grad(set_to_none=True)
        out = model(*stacks, folded=True)
        information_bottleneck(out, target, cfg.train_beta).backward()

    rows = profile_rows(step, (), calls=2)
    if not rows:
        log('inn breakdown: the profiler saw no device time')
        return
    dense = ('conv', 'gemm', 'xmma', 'cutlass', 'cudnn', 'sm90_', 'wgrad',
             'dgrad', 'implicit')
    conv = sum(ms for k, ms, _ in rows if any(w in k.lower() for w in dense))
    total = sum(ms for _, ms, _ in rows)
    log(f'inn breakdown (one microbatch of 64 at 96², fwd + IB loss + bwd, '
        f'profiler device ms): total {total:.2f}, convolutions and GEMMs '
        f'{conv:.2f} ({conv / total:.1%}), other {total - conv:.2f}; '
        f'largest: ' + '; '.join(f'{k[:50]} x{n} {ms:.2f}'
                                 for k, ms, n in rows[:8]))
    del model, stacks
    gc.collect()
    torch.cuda.empty_cache()


def phase_inn(M, train: str, val: str, work: str, card: str) -> dict:
    """``--model_inn`` at full width (9 views, 3 + 8 coupling blocks,
    ksize 2, dims 108): the README recipe's batch flags without
    ``--model_uncert`` for INN_STEPS steps (K1 accum x steps, no K3);
    validation of its checkpoint whole-scene and with ``--val_tile 64``
    (windows of 108, ``mu``'s side: the two-window probe keeps ``mu`` out
    of the stitched outputs), the stitched result, logvar and posterior
    against the whole scene's (INN_TILE_TOL; the result is a bin centre,
    compared by the share of pixels that moved); then the checkpoint
    exported and served over HTTP after one warm-up, its mean against the
    direct eval forward's (SERVE_TOL)."""
    import threading
    import numpy as np
    import torch
    from mmlf_tpu_torch.config import Config
    from mmlf_tpu_torch.data.hci4d import HCI4D
    from mmlf_tpu_torch.export import export_inference
    from mmlf_tpu_torch.models import build_model
    from mmlf_tpu_torch.serve import InferenceEngine, make_server
    from mmlf_tpu_torch.utils import pfm
    from mmlf_tpu_torch.validate import cli
    from mmlf_tpu_torch.validate.cli import load_model_state, scene_to_device

    run = os.path.join(work, 'run_inn')
    trained = phase_train(M, train, val, run, INN_STEPS, inn=True)
    k1, s_step, peak = (trained['launches']['window_gather'],
                        trained['s_step'], trained['peak'])
    del trained
    gc.collect()
    torch.cuda.empty_cache()
    inn_breakdown(run)

    scene = os.path.join(run, 'scenes', 'scene_00')
    outs, res = {}, {}
    for tile in (0, INN_TILE):
        reset_launches(M)
        torch.cuda.synchronize()
        t = time.time()
        res[tile] = cli.main([run, val, '--val_tile', str(tile)],
                             standalone_mode=False)
        torch.cuda.synchronize()
        res[tile]['wall'] = time.time() - t
        if read_launches(M) != expected(M):
            raise AssertionError(f'inn validate launched {read_launches(M)}')
        for key in METRICS:
            if not math.isfinite(res[tile][key]):
                raise AssertionError(f'inn metric {key} = {res[tile][key]}')
        outs[tile] = {f: pfm.load(os.path.join(scene, f)) for f in
                      ('result.pfm', 'uncert.pfm')}
        outs[tile]['posterior'] = np.load(os.path.join(scene,
                                                       'posterior.npy'))
        if outs[tile]['posterior'].shape != (108, SIZE, SIZE):
            raise AssertionError(f'inn posterior.npy '
                                 f'{outs[tile]["posterior"].shape}')
    w, tl = outs[0], outs[INN_TILE]
    moved = float((np.abs(tl['result.pfm'] - w['result.pfm']) > 1e-6).mean())
    d_post = float(np.abs(tl['posterior'] - w['posterior']).max())
    same = np.abs(tl['result.pfm'] - w['result.pfm']) <= 1e-6
    d_lv = float(np.abs(tl['uncert.pfm'] - w['uncert.pfm'])[same].max())
    if moved > 1e-3 or d_post > INN_TILE_TOL or d_lv > INN_TILE_TOL:
        raise AssertionError(
            f'inn --val_tile {INN_TILE} vs whole scene: result moved at '
            f'{moved:.2e} of pixels (limit 1e-3), max |d posterior| '
            f'{d_post:.3e}, max |d logvar| where the result agrees '
            f'{d_lv:.3e} (limit {INN_TILE_TOL})')
    log(f'inn: validate whole scene {res[0]["runtime"]:.3f} s/scene (CLI '
        f'runtime), {res[0]["wall"]:.3f} s CLI wall; --val_tile {INN_TILE} '
        f'(windows of {INN_TILE + 2 * 22}) {res[INN_TILE]["runtime"]:.3f} '
        f's/scene; tiled vs whole: result moved at {moved:.2e} of pixels, '
        f'max |d posterior| {d_post:.3e}, max |d logvar| {d_lv:.3e}; '
        f'metrics ' + json.dumps({k: res[0][k] for k in METRICS}))

    state, hyper = load_model_state(run)
    model = build_model(Config.from_dict(hyper))
    model.load_state_dict(state, strict=True)
    model.cuda().eval()
    stacks, _, _ = scene_to_device(HCI4D(val)[0], torch.device('cuda'))
    with torch.no_grad():
        direct = model(*stacks)['mean'][0].cpu().numpy()
    del model, stacks
    gc.collect()
    torch.cuda.empty_cache()

    serve_dir = os.path.join(work, 'serve_inn')
    os.makedirs(serve_dir)
    art = os.path.join(serve_dir, 'inn.mmlft')
    with open(art, 'wb') as f:
        f.write(export_inference(run, SIZE, SIZE))
    reset_launches(M)
    engine = InferenceEngine(art)
    server = make_server(engine, '127.0.0.1', 0)
    thread = threading.Thread(target=server.serve_forever, daemon=True)
    thread.start()
    out = os.path.join(serve_dir, 'out')
    req = {'scene_dir': os.path.join(val, 'scene_00'), 'out_dir': out}
    try:
        port = server.server_address[1]
        answers = [_http(port, 'POST', '/infer', req) for _ in range(2)]
    finally:
        server.shutdown()
        server.server_close()
        thread.join(timeout=60)
    del engine
    for status, resp, _ in answers:
        if status != 200:
            raise AssertionError(f'inn serve: {status} {resp}')
    if read_launches(M) != expected(M):
        raise AssertionError(f'inn request launched {read_launches(M)}')
    mean = np.flip(pfm.load(os.path.join(out, 'result.pfm')), 0)
    diff = float(np.abs(mean - direct).max())
    if mean.shape != (SIZE, SIZE) or not diff <= SERVE_TOL:
        raise AssertionError(f'inn serve: result.pfm {mean.shape}, max '
                             f'|d mean| against the direct forward {diff}')
    _, resp, http_wall = answers[1]
    log(f'inn_serve: request after one warm-up: runtime_s '
        f'{resp["runtime_s"]:.4f} s, HTTP wall {http_wall:.4f} s, max |d '
        f'mean| against the direct eval forward {diff:.3e} (limit '
        f'{SERVE_TOL}); INN train {s_step:.3f} s/step, '
        f'{peak / 2**30:.2f} GiB peak; card {card}')
    gc.collect()
    torch.cuda.empty_cache()
    return {'k1_launches': k1, 's_step': s_step, 'peak': peak,
            's_per_scene': res[0]['runtime'],
            's_per_scene_tiled': res[INN_TILE]['runtime'],
            'runtime_s': resp['runtime_s']}


def random_checkpoint(run: str) -> None:
    """A full-width UPR checkpoint (BatchNorm included) with seeded random
    weights that keep the net input-sensitive, for ``chip_smoke.py
    serve``."""
    from mmlf_tpu_torch.config import Config
    from mmlf_tpu_torch.models.feed_forward import FeedForward, init_live_
    from mmlf_tpu_torch.utils.convert import save_checkpoint_pt

    cfg = Config(model_uncert=True).finalize()
    model = init_live_(FeedForward.from_config(cfg), seed=0)
    os.makedirs(run)
    save_checkpoint_pt(os.path.join(run, 'checkpoint.pt'),
                       model.state_dict(), cfg)
    log(f'checkpoint: full width (chs {cfg.model_chs}, '
        f'{cfg.model_in_blocks}+{cfg.model_out_blocks} blocks), seeded '
        f'random weights')


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print('chip_smoke: CUDA is not available', file=sys.stderr)
        return 2
    sys.path.insert(0, REPO)
    try:
        from types import SimpleNamespace
        from mmlf_tpu_torch.ops import kernels
        from mmlf_tpu_torch.ops.kernels import build
        from mmlf_tpu_torch.ops.kernels import conv_block as C
        from mmlf_tpu_torch.ops.kernels import posterior as K
        from mmlf_tpu_torch.ops.kernels import window_gather as W
    except ImportError as e:
        print(f'chip_smoke: the port is not beside this script ({e})',
              file=sys.stderr)
        return 2
    M = SimpleNamespace(C=C, K=K, W=W, counters=kernels.counters)
    # fp32 without TF32 for every cuDNN call here, as the port's entry
    # points set it
    from mmlf_tpu_torch.utils.device import resolve_device
    resolve_device('cuda')

    card = smi('name,power.limit')
    log(f'card: {card}; torch {torch.__version__}, CUDA '
        f'{torch.version.cuda}, {torch.cuda.device_count()} device(s)')
    mode = sys.argv[1:]
    if mode not in ([], ['k3'], ['k2'], ['serve'], ['bf16'],
                    ['bf16_trunk'], ['host'], ['unet'], ['probes'], ['dp'],
                    ['k1'], ['dp4'], ['mesh_val'], ['inn'], ['analysis']):
        print(f'chip_smoke: unknown arguments {mode}', file=sys.stderr)
        return 2

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
    log('build: posterior by bins per thread: '
        + k2_instances(build.ptxas_report('posterior')))
    log('build: conv_block bf16 conv2x2_kernel and wgrad_kernel instances: '
        + bf16_instances(build.ptxas_report('conv_block')))
    if mode == ['k3']:
        phase_conv_block(M)
        phase_conv_block(M, bf16=True)
        return 0
    if mode == ['k2']:
        phase_kernel(K)
        return 0
    if mode == ['probes']:
        phase_probes(M, card)
        return 0

    work = os.path.join(REPO, 'build', 'chip_smoke')
    shutil.rmtree(work, ignore_errors=True)
    run = os.path.join(work, 'run')
    if mode == ['serve']:
        _, val = phase_data(work, n_train=0)
        random_checkpoint(run)
        main_run = phase_main(M, run, val)
        phase_serve(M, run, val, main_run, card)
        return 0
    if mode == ['analysis']:
        _, val = phase_data(work, n_train=0)
        random_checkpoint(run)
        phase_main(M, run, val)
        phase_analysis(run, val, card)
        return 0
    if mode == ['mesh_val']:
        _, val = phase_data(work, n_train=0)
        random_checkpoint(run)
        phase_mesh_val(M, run, val, work, phase_main(M, run, val), card)
        return 0
    train, val = phase_data(work)
    if mode == ['bf16']:
        bf16 = phase_bf16(M, train, val, work, card)
        phase_bf16_eval(M, bf16['run'], val, card)
        return 0
    if mode == ['bf16_trunk']:
        phase_train(M, train, val, os.path.join(work, 'run_bf16_trunk'),
                    TRUNK_STEPS, trunk=True, bf16=True)
        return 0
    if mode == ['host']:
        phase_host(train, val, card)
        phase_train_host(M, train, val, work, card)
        return 0
    if mode == ['unet']:
        phase_unet(M, train, val, work, card)
        return 0
    if mode == ['dp']:
        phase_dp(M, train, val, work, card)
        return 0
    if mode == ['inn']:
        phase_inn(M, train, val, work, card)
        return 0
    if mode == ['dp4']:
        if torch.cuda.device_count() < 4:
            raise RuntimeError(f'dp4 needs 4 cards, this machine has '
                               f'{torch.cuda.device_count()}')
        phase_dp(M, train, val, work, card, n_ranks=4, backend=None)
        return 0
    if mode == ['k1']:
        from mmlf_tpu_torch.data.hci4d import HCI4D
        from mmlf_tpu_torch.data.pipeline import DevicePipeline
        pipe = DevicePipeline(HCI4D(train, cache=True), recipe_config(train),
                              seed=0, device='cuda')
        for _ in range(2):
            phase_window_gather(W, pipe, 64)
        return 0
    host = phase_host(train, val, card)
    gc.collect()
    train_run = phase_train(M, train, val, run, TRAIN_STEPS)
    gather = phase_window_gather(W, train_run['pipeline'], train_run['size'])
    s_step, k1_launches = train_run['s_step'], \
        train_run['launches']['window_gather']
    per_step = k1_launches / TRAIN_STEPS
    log(f'train step shares: K1 {per_step * gather["ms"] / 1e3 / s_step:.2%}'
        f', gather + augmentation '
        f'{per_step * gather["aug_ms"] / 1e3 / s_step:.2%}, host sampler '
        f'{gather["sampler_s"] / s_step:.2%} of {s_step:.3f} s/step')
    del train_run
    gc.collect()            # the run's pipeline sits in a reference cycle
    torch.cuda.empty_cache()

    trunk_run = phase_train(M, train, val, os.path.join(work, 'run_trunk'),
                            TRUNK_STEPS, trunk=True)
    k3_launches = trunk_run['launches']['fused_double_conv_fwd']
    trunk_launches_bwd = trunk_run['launches']['fused_double_conv_bwd']
    trunk_k1 = trunk_run['launches']['window_gather']
    trunk_s, trunk_peak = trunk_run['s_step'], trunk_run['peak']
    del trunk_run
    gc.collect()
    torch.cuda.empty_cache()
    k3 = phase_conv_block(M)
    accum = int(RECIPE[RECIPE.index('--train_accum') + 1])
    log(f'train_trunk step shares: K3 fwd '
        f'{accum * k3["fwd"]["ms"] / 1e3 / trunk_s:.2%}, K3 bwd '
        f'{accum * k3["bwd"]["ms"] / 1e3 / trunk_s:.2%} of {trunk_s:.3f} '
        f's/step (plain trunk {s_step:.3f} s/step); peak device memory '
        f'{trunk_peak / 2**30:.2f} GiB')
    torch.cuda.empty_cache()
    bf16 = phase_bf16(M, train, val, work, card)
    train_host = phase_train_host(M, train, val, work, card)
    gc.collect()
    torch.cuda.empty_cache()
    unet = phase_unet(M, train, val, work, card)
    gc.collect()
    torch.cuda.empty_cache()
    dp = phase_dp(M, train, val, work, card)
    gc.collect()
    torch.cuda.empty_cache()
    inn = phase_inn(M, train, val, work, card)
    gc.collect()
    torch.cuda.empty_cache()
    probes = phase_probes(M, card)

    main_run = phase_main(M, run, val)
    gc.collect()
    torch.cuda.empty_cache()
    phase_analysis(run, val, card)
    gc.collect()
    torch.cuda.empty_cache()
    tiled_run = phase_main_tiled(M, run, val, main_run['gmm'],
                                 main_run['metrics'])
    gc.collect()
    torch.cuda.empty_cache()
    mesh_val = phase_mesh_val(M, run, val, work, main_run, card)
    for key in ('gmm', 'posterior'):
        del main_run[key]
    log(f'ESE validate: whole scene {main_run["s_per_scene"]:.3f} s/scene, '
        f'{main_run["peak_bytes"] / 2**30:.3f} GiB; --val_tile {VAL_TILE} '
        f'{tiled_run["s_per_scene"]:.3f} s/scene, '
        f'{tiled_run["peak_bytes"] / 2**30:.3f} GiB')
    gc.collect()
    torch.cuda.empty_cache()
    serve_run = phase_serve(M, run, val, main_run, card)
    del serve_run['results']
    gc.collect()
    torch.cuda.empty_cache()
    gc.collect()
    torch.cuda.empty_cache()
    bf16_eval = phase_bf16_eval(M, bf16['run'], val, card)
    gc.collect()
    torch.cuda.empty_cache()
    k2 = phase_kernel(K)
    kern = k2[K2_CASES[0]]
    phase_member_time()
    phase_breakdown(run, val, host)
    log(f'host pipeline and U-Net: train_host {train_host["s_step"]:.3f} '
        f's/step (sampler {train_host["sample_ms"]:.1f} ms, copy '
        f'{train_host["copy_ms"]:.1f} ms per batch, '
        f'{train_host["peak"] / 2**30:.2f} GiB); unet {unet["s_step"]:.3f} '
        f's/step, ESE {unet["s_per_scene"]:.3f} s/scene, served UPR '
        f'runtime_s {unet["runtime_s"]:.4f} s; card {card}')
    log(f'INN and sharded validation: inn {inn["s_step"]:.3f} s/step, '
        f'{inn["peak"] / 2**30:.2f} GiB, {inn["s_per_scene"]:.3f} s/scene '
        f'whole, {inn["s_per_scene_tiled"]:.3f} tiled, served runtime_s '
        f'{inn["runtime_s"]:.4f} s; ESE --mesh_ensemble 2 '
        f'{mesh_val["mesh_ensemble"]:.3f} s/scene, --mesh_space 2 '
        f'{mesh_val["mesh_space"]:.3f} s/scene (two gloo ranks on one card: '
        f'no scaling number; whole scene {main_run["s_per_scene"]:.3f}); '
        f'card {card}')
    torch.cuda.synchronize()

    kernels = [{
        'name': 'window_gather',
        'route': 'cuda',
        'source': 'mmlf_tpu_torch/csrc/window_gather.cu',
        'replaces': 'mmlf_tpu/ops/pallas/window_gather.py:94',
        # the plain, trunk, U-Net, dp and INN runs (the host run cuts on
        # the host)
        'launches': k1_launches + trunk_k1 + unet['k1_launches']
        + dp['launches']['window_gather']
        + dp['one_launches']['window_gather'] + inn['k1_launches'],
        'max_abs_err': gather['max_abs_err'],
        'ms': gather['ms'],
        'plain_ms': gather['plain_ms'],
        'bound_ms': gather['bound_ms'],
        'bound_by': gather['bound_by'],
        'library_ms': gather['library_ms'],
    }, {
        'name': 'window_gather_bf16',
        'route': 'cuda',
        'source': 'mmlf_tpu_torch/csrc/window_gather.cu',
        'replaces': 'mmlf_tpu/ops/pallas/window_gather.py:94',
        'launches': bf16['k1_launches'],
        'max_abs_err': bf16['gather']['max_abs_err'],
        'ms': bf16['gather']['ms'],
        'plain_ms': bf16['gather']['plain_ms'],
        'bound_ms': bf16['gather']['bound_ms'],
        'bound_by': bf16['gather']['bound_by'],
        'library_ms': bf16['gather']['library_ms'],
    }, {
        'name': 'laplace_mixture_posterior',
        'route': 'cuda',
        'source': 'mmlf_tpu_torch/csrc/posterior.cu',
        'replaces': 'mmlf_tpu/ops/pallas/posterior.py:48',
        # the main path's runs: validate whole and tiled, serve, the bf16
        # checkpoint's validate, the U-Net checkpoint's and the two ranks'
        # of --mesh_ensemble and --mesh_space
        'launches': (main_run['launches'] + tiled_run['launches']
                     + serve_run['launches'] + bf16_eval['launches']
                     + unet['k2_launches'] + mesh_val['launches']),
        'max_abs_err': max([r['max_abs_err'] for r in k2.values()]
                           + [main_run['max_abs_err']]),
        'ms': kern['ms'],
        'plain_ms': kern['plain_ms'],
        'bound_ms': kern['bound_ms'],
        'bound_by': kern['bound_by'],
        'library_ms': None,          # no single PyTorch call computes it
    }]
    # K3: times and bounds summed over one microbatch's 20 blocks, fp32
    # then bf16
    for (kind, line), sfx in ((k, s) for s in ('', '_bf16')
                              for k in (('fwd', 436), ('bwd', 514))):
        o = (bf16['k3'] if sfx else k3)[kind]
        if sfx:
            launches = bf16['k3_launches'][kind] + \
                train_host['launches'][f'fused_double_conv_{kind}_bf16']
        else:
            launches = (k3_launches if kind == 'fwd' else trunk_launches_bwd) \
                + dp['launches'][f'fused_double_conv_{kind}'] \
                + dp['one_launches'][f'fused_double_conv_{kind}']
        kernels.append({
            'name': f'fused_double_conv_{kind}{sfx}',
            'route': 'cuda',
            'source': 'mmlf_tpu_torch/csrc/conv_block.cu',
            'replaces': f'mmlf_tpu/ops/pallas/conv_block.py:{line}',
            'launches': launches,
            'max_abs_err': o['err'],
            'ms': o['ms'],
            'plain_ms': o['plain_ms'],
            'bound_ms': o['bound_ms'],
            'bound_by': o['bound_by'],
            'library_ms': None,      # no single PyTorch call computes it
        })
    kernels += probes
    print(json.dumps({'kernels': kernels}))
    print(card)
    print(json.dumps({'ok': True, 'device': {
        'platform': 'gpu', 'kind': torch.cuda.get_device_name(0),
        'count': torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == '__main__':
    sys.exit(main())
