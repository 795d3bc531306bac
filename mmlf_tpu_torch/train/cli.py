"""Training CLI — the flags of ``mmlf_tpu.train.cli`` (and so of the
reference), with the same defaults:
``python -m mmlf_tpu_torch.train.cli OUTPUT_DIR [flags]``.

Adds ``--device`` (default ``cuda``; raises when CUDA is absent, pass
``cpu`` to run on the CPU) and drops ``--jax_cache``, which has no meaning
here.  ``--mesh_data N`` starts N ranks of its own (``train/loop.train``),
so the command line is the JAX package's.  ``--model_inn`` trains the
invertible network (``models/inn.py``); ``--model_invertible`` raises
NotImplementedError('INNs are not supported anymore'), as the JAX package
and the reference do (``train/loop.check_ported``).
"""

import sys

import click

from ..config import Config
from .loop import train


@click.command()
@click.argument('output_dir', type=click.Path(exists=True))
@click.option('--model_ksize', default=2, help='Kernel size for convolutions, e.g. 3 for 3x3 kernels')
@click.option('--model_in_blocks', default=3, help='Number of blocks for input network')
@click.option('--model_out_blocks', default=8, help='Number of blocks for output network')
@click.option('--model_chs', default=70, help='Number of channels for input network')
@click.option('--model_views', default=9, help='Number of viewpoints of the input light field, e.g. 9 for 9+8 views')
@click.option('--model_cross', is_flag=True, help='Only use cross input?')
@click.option('--model_uncert', is_flag=True, help='Use uncertainty model?')
@click.option('--model_discrete', is_flag=True, help='Discretize disparity output?')
@click.option('--model_unet', is_flag=True, help='Use a U-Net after the multistream network?')
@click.option('--model_invertible', is_flag=True, help='Use invertible architecture?')
@click.option('--model_clamp', default=0.7, help='Output clamp for coupling block?')
@click.option('--model_act_norm', default=0.7, help='Activation normalization for coupling block?')
@click.option('--model_act_norm_type', default='SOFTPLUS', help='Type of activation normalization for coupling block?')
@click.option('--model_soft_permutation', is_flag=True, help='Use soft permuation for coupling block?')
@click.option('--model_no_batchnorm', is_flag=True, help='Disable BatchNorm layers')
@click.option('--model_batchnorm_momentum', default=0.1, help='Momentum for BatchNorm layers')
@click.option('--train_trainset', default='../lf-dataset/additional', help='Location of training dataset')
@click.option('--train_valset', default='../lf-dataset/training', help='Location of validation dataset')
@click.option('--train_no_data_augment', is_flag=True, help='Don\'t use any data augmentation?')
@click.option('--train_num_workers', default=4, help='Number of workers for data loader (host-pipeline window-cutter threads, 0 = cut in the loop\'s thread; the device-cache path cuts its windows on the card and ignores this)')
@click.option('--train_lr', default=1e-5, help='Learning rate')
@click.option('--train_bs', default=1, help='Batch size')
@click.option('--train_ps', default=32, help='Size of training patches')
@click.option('--train_beta', default=1.0, help='Weighting between NLL and Cat CE')
@click.option('--train_mae_threshold', default=0.02, help='If the MAE of one patch is under this threshold, no loss is applied')
@click.option('--train_max_downscale', default=4, help='Maximum factor of down scaling for data augmentation')
@click.option('--train_resume', is_flag=True, help='Resume training from old checkpoint?')
@click.option('--train_loss_padding', default=None, type=float, help='Margin around ground truth to apply loss')
@click.option('--train_shift', default=0.0, type=float, help='Static shift to apply to off-center training datasets')
@click.option('--train_loss_multimodal', is_flag=True, help='Use multimodal training loss?')
@click.option('--train_loss_strongest', is_flag=True, help='Use strongest depth instead of nearest?')
@click.option('--train_eval_mode', is_flag=True, help='Also train in eval mode?')
@click.option('--train_eval_mode_start', default=0, help='Start iteration for eval mode')
@click.option('--train_warm_start', is_flag=True, help='Use lower learning rate during initial iterations?')
@click.option('--train_cooling', default=0, help='Cooling interval')
@click.option('--val_interval', default=100, help='Validation interval')
@click.option('--val_loss_margin', default=15, help='Margin around each image to omit for the validation loss.')
@click.option('--val_ensamble', is_flag=True, help='Use a network ensamble?')
@click.option('--val_disp_min', default=-3.5, help='Minimum disparity of dataset')
@click.option('--val_disp_max', default=3.5, help='Maximum disparity of dataset')
@click.option('--val_disp_step', default=0.1, help='Disparity increment for ensamble')
@click.option('--mesh_data', default=0, help='data-parallel mesh size; 0 = all devices (N ranks: one a GPU over NCCL; on the CPU, N gloo ranks)')
@click.option('--train_seed', default=0, help='RNG seed for init + augmentation')
@click.option('--train_steps', default=0, help='stop after N steps; 0 = run forever')
@click.option('--bf16', is_flag=True, help='bfloat16 conv trunk')
@click.option('--host_pipeline', is_flag=True,
              help='force host-side window extraction (the host pipeline)')
@click.option('--remat', is_flag=True,
              help='rematerialize conv blocks (recompute them in the '
                   'backward; the fused trunk ignores it)')
@click.option('--pallas_trunk', is_flag=True,
              help='run the train-mode conv trunk (the four streams and '
                   'the out_net) through the fused double-conv kernel K3; '
                   'eval stays on the plain path')
@click.option('--train_accum', default=1,
              help='gradient-accumulation microbatches: bs=512 as '
                   '8x64 reproduces the reference 8-GPU recipe on one card')
@click.option('--train_accum_exact', is_flag=True,
              help='count-weighted accumulation: exact global-batch '
                   'masked-mean loss/grad under --train_accum even with '
                   'unequal per-chunk masks (the README recipe measures '
                   'identical either way — docs/STATUS.md round 5)')
@click.option('--cache_bf16', is_flag=True,
              help='bfloat16 image scene cache')
@click.option('--train_profile', is_flag=True,
              help='capture a torch.profiler trace of steps 10-15')
@click.option('--train_nan_guard', is_flag=True,
              help='stop when the loss goes non-finite')
@click.option('--train_logvar_warmup', default=0,
              help='ramp the uncertainty-loss logvar coupling over N '
                   'steps (step 0 trains plain L1, reference loss by step '
                   'N); a rescue lever for the seed-dependent logvar '
                   'collapse of the UPR recipe — repairs the mean head, '
                   'but logvar calibration (ESE selection) stays '
                   'run-fragile either way: validate ESE per checkpoint. '
                   '0 = reference-exact')
@click.option('--train_logvar_anchor', default=0.0, type=float,
              help='weight of the logvar calibration anchor: '
                   'quadratic pull of logvar toward the detached per-pixel '
                   'log|error| (the heteroscedastic loss\'s own pointwise '
                   'optimum, made non-tradeable).  Prevents both the '
                   'logvar collapse and the shift-tracking miscalibration '
                   'that break ESE min-logvar selection. 0 = '
                   'reference-exact')
@click.option('--train_term_checkpoint/--no_train_term_checkpoint',
              default=True,
              help='on SIGTERM (preemption) checkpoint the current '
                   'step and exit cleanly; resume with --train_resume')
@click.option('--model_inn', is_flag=True,
              help='the working invertible network of mmlf_tpu (the '
                   'reference\'s --model_invertible is dead upstream and '
                   'fails identically here; this trains the real INN)')
@click.option('--device', default='cuda',
              help='Torch device to run on (default cuda; raises when CUDA '
                   'is absent — pass cpu to run on the CPU).')
def main(output_dir, device, **kwargs):
    cfg = Config.from_dict(kwargs).finalize()
    return train(cfg, output_dir, device=device)


if __name__ == '__main__':
    sys.exit(main())
