"""Validation / inference CLI — full-scene metrics + artifact dump.

``python -m mmlf_tpu_torch.validate.cli OUTPUT_DIR DATASET [flags]`` with the
flags of ``mmlf_tpu.validate.cli`` (plus ``--device``).

Flow: the model is rebuilt from the checkpoint's stored hyper-parameters,
with CLI flags overriding only ``model_discrete``, the disparity range and
``train_shift``; BatchNorm is folded into the convolutions; scenes run at
full resolution (batch 1) through the model or, with ``--val_ensamble``,
the 70-member shift ensemble; per-scene MSE / BadPix(0.07) with a margin
mask; the head's output becomes a 108-bin posterior for KLD (all /
multimodal / unimodal pixels) and NLL; the artifacts are written by
``save_batch``, and a LaTeX-ready result row is printed.  The metric branch
is keyed off the STORED config, as in the reference.

``--val_tile N`` runs the forward (or the whole ensemble, with its
mixture posterior) over overlapping windows of ``N + 2 * halo`` pixels and
stitches the interiors (validate/tiling.py); the halo is the receptive
radius, plus ``ceil(max |disp|) + 1`` for the ensemble, as in the JAX
package.  The metrics are taken on the stitched outputs.  With the
ensemble a window's view shifts wrap around the window's edge, not the
scene's, so near the image border (within the largest shift plus the
receptive radius, 25 px at full width) the members, and so the metrics,
differ slightly from the whole-scene run, as in the JAX package.

Runs on the card by default (``--device cuda``) in float32 with TF32 off,
and raises when CUDA is asked for but absent.  A checkpoint whose stored
config has ``bf16`` evaluates with the bfloat16 trunk, BatchNorm folded
into the float32 weights first (as ``mmlf_tpu.validate.cli``); the
posterior kernel and the metrics stay float32.  Reads the JAX package's
``checkpoint.msgpack`` (with its ``hyper_parameters.json``) first, as
``mmlf_tpu.validate.cli`` does, else a reference-format ``checkpoint.pt``.
A ``--model_unet`` checkpoint runs with its BatchNorm unfolded, as in the
JAX package, and so does an INN (``--model_inn``) checkpoint, whose
posterior is its cluster grid: ``--model_discrete`` and
``--val_ensamble`` are usage errors for it, and its NLL is the discrete
one when it has 108 clusters (the Laplace one under ``--model_cross``).
``--model_invertible`` is accepted and ignored, as the JAX CLI does.

``--mesh_ensemble N`` (with ``--val_ensamble``) splits the members over N
ranks (``ensemble_forward_sharded``); ``--mesh_space N`` splits each
scene's rows (``validate/spatial.py``).  Either starts N processes
(``run_validation_ranks``: NCCL with one rank a GPU, gloo on the CPU;
more ranks than GPUs is a ``ValueError``, as the JAX package's mesh
raises); rank 0 loads, scores, writes the artifacts and prints, the
others compute and run the same collectives.  Their outputs are the
whole-scene run's within float rounding.
``--jax_cache`` has no counterpart: nothing is compiled per scene here.
"""

from __future__ import annotations

import json
import os
import sys
import time

import click
import numpy as np
import torch

from ..config import Config
from ..data import transforms as T
from ..data.hci4d import HCI4D, pad_mpi
from ..losses import masked_badpix, masked_mse
from ..models import build_model
from ..models.ensemble import (ensemble_forward, ensemble_forward_sharded,
                               ensemble_grid)
from ..ops.codecs import mpi_to_weights
from ..ops.masks import create_mask_margin
from ..parallel import mesh
from ..trace import span
from ..train.checkpoint import CKPT_MSGPACK, CKPT_PT, load_checkpoint_raw
from ..utils.convert import load_checkpoint_pt, state_dict_from_jax
from ..utils.device import resolve_device
from ..utils.fold_bn import fold_batchnorm
from . import calibrate
from . import posteriors as P
from .spatial import SlabForward, gather_rows
from .tiling import (UNET_ALIGN, UNET_MSG, receptive_radius, tiled_forward,
                     unet_halo)


def load_model_state(output_dir: str):
    """Load ``(state_dict, stored_config_dict)`` from the JAX package's
    ``checkpoint.msgpack`` (its ``params`` and ``batch_stats`` mapped onto
    the port's keys) or, failing that, a reference-format
    ``checkpoint.pt``."""
    if os.path.exists(os.path.join(output_dir, CKPT_MSGPACK)):
        tree, _, hyper = load_checkpoint_raw(output_dir)
        variables = {'params': tree['params'],
                     'batch_stats': tree.get('batch_stats', {})}
        return state_dict_from_jax(variables, hyper), hyper
    pt = os.path.join(output_dir, CKPT_PT)
    if os.path.exists(pt):
        return load_checkpoint_pt(pt)
    raise FileNotFoundError(
        f'no {CKPT_MSGPACK} or {CKPT_PT} in {output_dir}')


def make_scene_eval(model, cfg: Config, kwargs: dict, val_ensamble: bool,
                    val_disp_min: float, val_disp_max: float,
                    val_disp_step: float, val_loss_margin: int,
                    n_bins: int = 108, val_tile: int = 0,
                    mesh_ensemble: int = 1, mesh_space: int = 1):
    """Forward + every metric for one scene.

    Returns ``scene_eval(h, v, i, d, gt, mpi, offsets=None) -> (output,
    metrics)`` on device tensors (batch-first stacks, gt ``(b, H, W)``,
    MPI ``(b, K, H, W, 5)``); metrics are 0-d tensors.  ``val_tile > 0``
    runs the forward tile by tile (``tiling.tiled_forward``): exact for
    BASE/UPR/DPP and the INN; for the ensemble the sub-pixel shift's
    circular wrap lands in the tile window's edge instead of the image
    border, as in the JAX package.  ``mesh_ensemble > 1`` splits the
    ensemble's members over the ranks of the process group
    (``ensemble_forward_sharded``), ``mesh_space > 1`` each scene's rows
    (``spatial.SlabForward``); the outputs are then the whole scene's on
    every rank, and ``metrics`` is None except on rank 0.
    """
    inn = bool(kwargs.get('model_inn'))
    halo = receptive_radius(cfg.model_ksize, cfg.model_in_blocks,
                            cfg.model_out_blocks)
    if mesh_space > 1:
        # the ensemble's members shift the whole scene before the slab is
        # cut (SlabForward is its model); a U-Net's slabs keep the scene's
        # pooling grid and cover its receptive field
        if cfg.model_unet:
            slab = SlabForward(model, unet_halo(cfg.model_ksize,
                                                cfg.model_in_blocks),
                               align=UNET_ALIGN)
        else:
            slab = SlabForward(model, halo, probe=inn)

    def net_forward(h, v, i, d, offsets):
        if mesh_ensemble > 1:
            return ensemble_forward_sharded(
                model, h, v, i, d, val_disp_min, val_disp_max,
                val_disp_step, member_offsets=offsets)
        fn = slab if mesh_space > 1 else model
        if val_ensamble:
            out = ensemble_forward(fn, h, v, i, d, disp_min=val_disp_min,
                                   disp_max=val_disp_max,
                                   disp_step=val_disp_step,
                                   member_offsets=offsets)
        else:
            out = fn(h, v, i, d)
        if mesh_space > 1:
            out = gather_rows(out, h.shape[2] // mesh_space, h.shape[3])
        return out

    def metrics_from_output(output, gt, mpi):
        mask = create_mask_margin(gt.shape, val_loss_margin, gt.device)
        mse = masked_mse(output, gt, mask)
        bad_pix = masked_badpix(output, gt, mask)

        dist_gt = mpi_to_weights(mpi, cfg.val_disp_min, cfg.val_disp_max,
                                 n_bins)

        # head-specific 108-bin posterior + NLL, keyed off the STORED config
        nll_eval = torch.zeros((), device=gt.device)
        if kwargs.get('val_ensamble'):
            # reference quirk: exp(logvars) is passed as "logvars" and
            # exponentiated again inside (see posteriors.lmm_to_discrete)
            dist = P.lmm_to_discrete(n_bins, cfg.val_disp_min,
                                     cfg.val_disp_max, output['means'],
                                     torch.exp(output['logvars']))
        elif kwargs.get('model_discrete'):
            weights = mpi_to_weights(mpi, cfg.val_disp_min,
                                     cfg.val_disp_max, model.steps)
            dist = output['posterior']
            nll_eval = P.nll_discrete(weights, output['posterior'])
        elif inn and output['posterior'].shape[-1] == n_bins:
            # the INN's posterior is over linspace(min, max, dims), the
            # 108-bin report's grid when dims == 108
            dist = output['posterior']
            nll_eval = P.nll_discrete(dist_gt, output['posterior'])
        elif kwargs.get('model_uncert') or inn:
            # an INN of another cluster count (--model_cross: 54)
            dist = P.laplace_to_discrete(n_bins, cfg.val_disp_min,
                                         cfg.val_disp_max, output['mean'],
                                         output['logvar'])
            nll_eval = P.nll_laplace(mpi, output['mean'], output['logvar'])
        else:
            nll_eval = P.nll_laplace(mpi, output['mean'],
                                     torch.zeros_like(output['mean']))
            dist = P.mean_to_discrete(n_bins, cfg.val_disp_min,
                                      cfg.val_disp_max, output['mean'])

        mm_mask = P.multimodal_mask(mpi)
        kld = P.kl_divergence(dist, dist_gt)
        kld_mm = P.kl_divergence(dist, dist_gt, mm_mask)
        kld_um = P.kl_divergence(dist, dist_gt, 1.0 - mm_mask)

        return {'mse': mse, 'bad_pix': bad_pix, 'nll': nll_eval,
                'kld': kld, 'kld_mm': kld_mm, 'kld_um': kld_um}

    if val_ensamble:       # the ensemble's shift reaches ceil(disp)+1 further
        halo += int(np.ceil(max(abs(val_disp_min), abs(val_disp_max)))) + 1

    @torch.no_grad()
    def scene_eval(h, v, i, d, gt, mpi, offsets=None):
        if val_tile > 0:
            output = tiled_forward(
                lambda *win: net_forward(*win, offsets), (h, v, i, d),
                val_tile, halo, probe=inn)
        else:
            output = net_forward(h, v, i, d, offsets)
        if mesh.rank() != 0:
            return output, None
        return output, metrics_from_output(output, gt, mpi)

    return scene_eval


def scene_to_device(sample, dev):
    """Batch-1 device tensors of a sample's four stacks, gt and padded
    MPI."""
    h, v, i, d, _, gt, mpi = sample[:7]
    stacks = [torch.from_numpy(np.ascontiguousarray(x[None])).to(dev)
              for x in (h, v, i, d)]
    return (stacks, torch.from_numpy(gt[None].copy()).to(dev),
            torch.from_numpy(pad_mpi(mpi)[None]).to(dev))


def _rank_validate(output_dir, dataset, kwargs, device_type) -> dict:
    """One rank of ``run_validation_ranks`` (in its own process and
    group): rank 0's metric averages, and every rank's launch counts."""
    from ..ops.kernels import launch_counts
    dev = mesh.rank_device(device_type, mesh.rank())
    result = run_validation(output_dir, dataset, device=dev, **kwargs)
    return {'rank': mesh.rank(), 'result': result,
            'launches': launch_counts()}


def run_validation_ranks(output_dir, dataset, n_ranks: int, device='cuda',
                         backend: str | None = None,
                         timeout: float | None = None, **kwargs) -> dict:
    """``run_validation`` with ``--mesh_ensemble`` or ``--mesh_space`` on
    ``n_ranks`` new processes (``parallel/mesh.launch``): NCCL with one
    rank a GPU by default on CUDA, gloo on the CPU; ``backend='gloo'``
    lets several ranks share one GPU (which gives no scaling).  Rank 0
    loads, scores, writes the artifacts and prints; the others compute
    their members or rows and run the same collectives.  Returns rank 0's
    metric averages with ``ranks``: each rank's launch counts."""
    dev = resolve_device(device)
    mesh.check_devices(n_ranks, dev.type, backend)
    reports = mesh.launch(_rank_validate, n_ranks,
                          (output_dir, dataset, kwargs, dev.type),
                          device_type=dev.type, backend=backend,
                          timeout=timeout)
    return dict(reports[0]['result'],
                ranks=[{'rank': r['rank'], 'launches': r['launches']}
                       for r in reports])


def run_validation(output_dir, dataset, model_discrete=False,
                   val_loss_margin=15, val_ensamble=False,
                   val_disp_step=0.1, val_disp_min=-3.5, val_disp_max=3.5,
                   train_shift=0.0, val_tile=0, mesh_space=1,
                   mesh_ensemble=1, val_recalibrate='', val_cal_scenes=2,
                   val_save_calibration='', device='cuda'):
    """Programmatic entry (the CLI body); returns the metric averages.

    With ``mesh_ensemble`` or ``mesh_space`` above 1 it starts that many
    ranks (``run_validation_ranks``); inside a rank's group it is that
    rank's run."""
    # the three scene-scale extensions are mutually exclusive (each owns
    # the devices / the forward in a different way)
    if sum([val_tile > 0, mesh_space > 1, mesh_ensemble > 1]) > 1:
        raise click.UsageError('--val_tile, --mesh_space and '
                               '--mesh_ensemble are mutually exclusive')
    if mesh_ensemble > 1 and not val_ensamble:
        raise click.UsageError('--mesh_ensemble requires --val_ensamble')
    n_ranks = max(mesh_space, mesh_ensemble)
    kw = dict(model_discrete=model_discrete, val_loss_margin=val_loss_margin,
              val_ensamble=val_ensamble, val_disp_step=val_disp_step,
              val_disp_min=val_disp_min, val_disp_max=val_disp_max,
              train_shift=train_shift, val_tile=val_tile,
              mesh_space=mesh_space, mesh_ensemble=mesh_ensemble,
              val_recalibrate=val_recalibrate, val_cal_scenes=val_cal_scenes,
              val_save_calibration=val_save_calibration)
    if n_ranks > 1 and mesh.world() == 1:
        return run_validation_ranks(output_dir, dataset, n_ranks,
                                    device=device, **kw)
    if mesh.world() != n_ranks:
        raise ValueError(f'a group of {mesh.world()} ranks runs '
                         f'--mesh_ensemble/--mesh_space {n_ranks}')
    dev = resolve_device(device)
    lead = mesh.rank() == 0
    say = print if lead else (lambda *a, **k: None)

    state, kwargs = load_model_state(output_dir)
    # stored config + whitelisted CLI overrides
    kwargs.update({'model_discrete': model_discrete,
                   'val_disp_min': val_disp_min,
                   'val_disp_max': val_disp_max,
                   'train_shift': train_shift})
    cfg = Config.from_dict(kwargs)
    if val_tile > 0 and cfg.model_unet:
        raise click.UsageError(UNET_MSG)

    transform = T.Shift(float(kwargs['train_shift']))
    valset = HCI4D(dataset, transform=transform)

    # inference is eval-mode only: fold BatchNorm into the convolutions,
    # except in a U-Net net and an INN (not foldable), as the JAX package
    # does
    fold = not cfg.model_no_batchnorm and not cfg.model_unet \
        and not cfg.model_inn
    if fold:
        cfg = Config.from_dict({**cfg.to_dict(), 'model_no_batchnorm': True})
    if cfg.model_inn:
        kwargs['model_inn'] = True
        # the JAX CLI checks the stored val_ensamble only, and its
        # --val_ensamble then fails with a TypeError (ROADMAP Queue 3)
        if kwargs.get('model_discrete') or kwargs.get('val_ensamble') or \
                val_ensamble:
            raise click.UsageError(
                '--model_discrete/--val_ensamble do not apply to an INN '
                'checkpoint (its posterior is already the cluster grid)')
    model = build_model(cfg)
    model.load_state_dict(fold_batchnorm(state) if fold else state,
                          strict=True)
    model.to(dev).eval()
    say('Number of parameters:', sum(p.numel() for p in model.parameters()))

    n_bins = 108
    scene_eval = make_scene_eval(model, cfg, kwargs, val_ensamble,
                                 val_disp_min, val_disp_max, val_disp_step,
                                 val_loss_margin, n_bins, val_tile,
                                 mesh_ensemble=mesh_ensemble,
                                 mesh_space=mesh_space)

    # --- ESE logvar-calibration machinery (validate/calibrate.py) ---
    # every rank fits the same offsets from the same gathered members
    shifts_grid = None
    member_offsets = None
    if val_ensamble:
        shifts_grid = ensemble_grid(val_disp_min, val_disp_max,
                                    val_disp_step)
        if val_recalibrate:
            calset = HCI4D(val_recalibrate, transform=transform)
            cal_stats = []
            for j in range(min(val_cal_scenes, len(calset.scenes))):
                say(f'Calibrating on scene {j} of {val_recalibrate}...')
                sample = calset[j]
                stacks, cgt, cmpi = scene_to_device(sample, dev)
                out_c, _ = scene_eval(*stacks, cgt, cmpi)
                m = create_mask_margin(sample[5].shape, val_loss_margin)
                cal_stats.append((out_c['means'][:, 0].cpu().numpy(),
                                  out_c['logvars'][:, 0].cpu().numpy(),
                                  sample[5], m.numpy()))
            member_offsets = calibrate.fit_member_offsets(cal_stats)
            say(f'Fitted member logvar offsets: mean '
                f'{member_offsets.mean():+.3f}, range '
                f'[{member_offsets.min():+.3f}, '
                f'{member_offsets.max():+.3f}]')
    cal_scenes = []

    mse_avg = bad_pix_avg = 0.0
    kld_avg = kld_mm_avg = kld_um_avg = nll_eval_avg = 0.0
    runtime = 0.0
    nll_eval = 0.0
    n_scenes = len(valset.scenes)

    for i in range(n_scenes):
        say(f'Processing scene {i}...')
        t_start = time.time()

        with span('mmlf.val.load'):
            sample = valset[i]
            stacks, gt_t, mpi_t = scene_to_device(sample, dev)
        gt, index = sample[5], sample[8]
        output, metrics = scene_eval(*stacks, gt_t, mpi_t, member_offsets)
        if not lead:
            continue

        # the host's waits for the card: the metrics and every output
        with span('mmlf.val.readback'):
            metrics = {k: float(v) for k, v in metrics.items()}
            means_np = logvars_np = None
            if output.get('means') is not None:
                means_np = output['means'].cpu().numpy()
                logvars_np = output['logvars'].cpu().numpy()
            mean = output['mean'].cpu().numpy()
            logvar = output.get('logvar')
            logvar = None if logvar is None else logvar.cpu().numpy()
            scores = output.get('scores')
            nll_arr = None if scores is None else \
                scores.permute(0, 3, 1, 2).cpu().numpy()
            posterior = output.get('posterior')
            post_arr = None if posterior is None else \
                posterior.permute(0, 3, 1, 2).cpu().numpy()

        if val_ensamble and means_np is not None:
            with span('mmlf.val.calibration'):
                m = create_mask_margin(gt.shape, val_loss_margin).numpy()
                cal_scenes.append(calibrate.scene_calibration(
                    shifts_grid, means_np[:, 0], logvars_np[:, 0], gt, m))

        mse_avg += metrics['mse']
        bad_pix_avg += metrics['bad_pix']
        print(metrics['mse'], metrics['bad_pix'])

        # ESE mixture parameters; note vars := exp(logvars) — the reference
        # stores and *reuses* these as "logvars" downstream (quirk)
        lmm = None
        if means_np is not None and logvars_np is not None:
            lmm = np.stack([means_np, np.exp(logvars_np)], 0)

        runtime = time.time() - t_start
        with span('mmlf.val.save'):
            valset.save_batch(output_dir, np.asarray(index)[None], mean,
                              logvar, runtime, lmm, nll_arr, post_arr,
                              sample=sample)

        nll_eval = metrics['nll']
        print(metrics['kld_um'], metrics['kld_mm'], metrics['kld'])

        kld_avg += metrics['kld']
        kld_mm_avg += metrics['kld_mm']
        kld_um_avg += metrics['kld_um']
        nll_eval_avg += nll_eval
    if not lead:
        return {}

    mse_avg /= n_scenes
    bad_pix_avg /= n_scenes
    kld_avg /= n_scenes
    kld_mm_avg /= n_scenes
    kld_um_avg /= n_scenes
    nll_eval_avg /= n_scenes

    print('MSE & BadPix007 & KLD_UM & KLD_MM & KLD & - & TIME \\\\')
    print(f'{mse_avg:.3f} & {bad_pix_avg:.3f} & {kld_um_avg:.3f} & '
          f'{kld_mm_avg:.3f} & {kld_avg:.3f} & - & {runtime:.3f} \\\\')
    print('NLL: ', nll_eval)

    result = {'mse': mse_avg, 'badpix': bad_pix_avg, 'kld': kld_avg,
              'kld_mm': kld_mm_avg, 'kld_um': kld_um_avg,
              'nll': nll_eval_avg, 'runtime': runtime}

    if cal_scenes:
        report = calibrate.calibration_report(cal_scenes, mse_avg)
        bare = ('n/a' if report['bare_mse'] is None
                else f"{report['bare_mse']:.5f}")
        print(f"ESE calibration: rank-corr {report['rank_corr']:+.3f}, "
              f"bare MSE {bare}, ESE MSE {report['ese_mse']:.5f}"
              + (' (recalibrated)' if member_offsets is not None else ''))
        for w in report['warnings']:
            print(w, file=sys.stderr)
        result['ese_calibration'] = report
        if val_save_calibration:
            payload = dict(report,
                           member_offsets=None if member_offsets is None
                           else [float(x) for x in member_offsets],
                           val_disp_min=val_disp_min,
                           val_disp_max=val_disp_max,
                           val_disp_step=val_disp_step)
            with open(val_save_calibration, 'w') as f:
                json.dump(payload, f, indent=1)
            print(f'calibration report written to {val_save_calibration}')

    return result


@click.command()
@click.argument('output_dir', type=click.Path(exists=True))
@click.argument('dataset', type=click.Path(exists=True))
@click.option('--model_invertible', is_flag=True,
              help='Use invertible architecture? (accepted and ignored, as '
                   'in mmlf_tpu.validate.cli)')
@click.option('--model_discrete', is_flag=True,
              help='Discretize disparity output?')
@click.option('--val_loss_margin', default=15,
              help='Margin around each image to omit for the validation loss')
@click.option('--val_ensamble', is_flag=True,
              help='Use a network ensamble?')
@click.option('--val_disp_min', default=-3.5,
              help='Minimum disparity of dataset')
@click.option('--val_disp_max', default=3.5,
              help='Maximum disparity of dataset')
@click.option('--val_disp_step', default=0.1,
              help='Disparity increment for ensamble')
@click.option('--train_shift', default=0.0, type=float,
              help='Static shift to apply to off-center training datasets')
@click.option('--val_tile', default=0, type=int,
              help='Tiled inference with this interior tile size '
                   '(0 = whole-scene forward). Exact for non-ensemble '
                   'heads; bounds device memory for large scenes. With '
                   '--val_ensamble the view shifts wrap at each window\'s '
                   'edge, so members and the ESE metrics can differ from '
                   'the whole-scene run near the image border (within the '
                   'largest shift plus the receptive radius).')
@click.option('--mesh_space', default=1, type=int,
              help='Split each scene\'s rows over this many ranks (one a '
                   'GPU; each runs its rows plus a receptive-field halo).')
@click.option('--mesh_ensemble', default=1, type=int,
              help='Split the --val_ensamble members over this many ranks '
                   '(one a GPU; each runs ceil(K/N) members; gathered '
                   'selection, K2 on the gathered members).')
@click.option('--val_recalibrate', default=None,
              type=click.Path(exists=True, dir_okay=True, file_okay=False),
              help='Requires --val_ensamble: fit per-member logvar offsets '
                   'on --val_cal_scenes scenes of this calibration dataset '
                   'and apply them to member selection and the mixture '
                   'posterior (validate/calibrate.py).')
@click.option('--val_cal_scenes', default=2, type=int,
              help='Number of calibration scenes --val_recalibrate fits on.')
@click.option('--val_save_calibration', default='', type=click.Path(),
              help='Write the ESE calibration report (and fitted offsets, '
                   'if any) as JSON.')
@click.option('--device', default='cuda',
              help='Torch device to run on (default cuda; raises when CUDA '
                   'is absent — pass cpu to run on the CPU).')
def main(output_dir, dataset, model_invertible, model_discrete,
         val_loss_margin, val_ensamble, val_disp_step, val_disp_min,
         val_disp_max, train_shift, val_tile, mesh_space, mesh_ensemble,
         val_recalibrate, val_cal_scenes, val_save_calibration, device):
    # --model_invertible is accepted and ignored, as mmlf_tpu.validate.cli
    return run_validation(output_dir, dataset, model_discrete=model_discrete,
                          val_loss_margin=val_loss_margin,
                          val_ensamble=val_ensamble,
                          val_disp_step=val_disp_step,
                          val_disp_min=val_disp_min,
                          val_disp_max=val_disp_max,
                          train_shift=train_shift, val_tile=val_tile,
                          mesh_space=mesh_space,
                          mesh_ensemble=mesh_ensemble,
                          val_recalibrate=val_recalibrate,
                          val_cal_scenes=val_cal_scenes,
                          val_save_calibration=val_save_calibration,
                          device=device)


if __name__ == '__main__':
    main()
