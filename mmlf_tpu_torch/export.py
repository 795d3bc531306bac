"""Export of a checkpoint's inference program as one artifact file.

``python -m mmlf_tpu_torch.export RUN ARTIFACT --height 512 --width 512``
packages what a server needs to answer requests for the checkpoint in
``RUN`` (``checkpoint.msgpack`` of the JAX package or a reference-format
``checkpoint.pt``): the BatchNorm-folded weights and a meta record (the
stored config, the conv trunk's dtype (``bfloat16`` for a ``--bf16``
checkpoint, which the served model runs in), the ensemble grid and
calibration, the ingest mode, the served shape and batch).  The flags are
those of ``mmlf_tpu.export`` but ``--platforms`` and ``--jax_cache``:
nothing is lowered or compiled, and the export runs on the host.

The file: the magic ``MMLFPT01``, three little-endian u64 lengths (meta,
weights, program), the JSON meta record, then the weights as
``torch.save`` of the folded state dict.  The program section is empty.
Unlike the JAX package's StableHLO artifact (``MMLFEXP1``), which loads
without the model source, this one is run by this package's code
(``FeedForward`` or the INN, ``ensemble_forward`` with the
mixture-posterior kernel, ``tiled_forward``), so it needs
``mmlf_tpu_torch`` to load.  An INN (``--model_inn``) checkpoint exports
untiled, in fp32 or u8, with its BatchNorm unfolded; ``val_ensamble`` and
``tiled`` raise ``ValueError`` for it, as in the JAX package.  A traced
program (``torch.export``) would need the package all the same: the
ensemble's posterior is a CUDA kernel launched through ctypes, which a
graph can only call as a custom op that this package registers.

Loading: ``fn, meta = load_exported(path, device='cuda')``;
``fn(h, v, i, d)`` (``fn(h, v, i, d, shift)`` for a ``--u8`` artifact)
takes ``(batch, views, H, W, 3)`` stacks and returns the model's output
dict as tensors on the device.
"""

from __future__ import annotations

import io
import json
import sys

import click
import numpy as np
import torch

from .config import Config
from .models.ensemble import ensemble_forward
from .models import build_model
from .ops.shift import shift_lf
from .utils.device import resolve_device
from .utils.fold_bn import fold_batchnorm
from .validate.cli import load_model_state
from .validate.tiling import UNET_MSG, receptive_radius, tiled_forward

MAGIC = b'MMLFPT01'
JAX_MAGIC = b'MMLFEXP1'
HEAD = len(MAGIC) + 3 * 8


def build_inference(output_dir: str, val_ensamble: bool = False,
                    val_disp_min: float = -3.5, val_disp_max: float = 3.5,
                    val_disp_step: float = 0.1, members: bool = False,
                    u8: bool = False, calibration: dict | None = None,
                    tiled: int = 0):
    """``(model, meta)``: the checkpoint's eval model on the CPU and the
    meta record of its inference program (``inference_fn`` runs the two).

    As the validate CLI rebuilds it: the stored hyper-parameters win, with
    the disparity range from the arguments, and BatchNorm is folded into
    the convolutions (the stored config then reads
    ``model_no_batchnorm``), except in a U-Net net and an INN.  ``val_ensamble``
    runs the shift ensemble, whose ``(K, b, H, W)`` member stacks are kept
    only with ``members``.
    ``u8`` takes raw uint8 stacks and a shift, normalized and shifted on
    the device.  ``calibration`` is the validate CLI's
    ``--val_save_calibration`` payload: its guard scores go into the meta
    (``/healthz`` serves them) and its ``member_offsets``, when present,
    into the ensemble.  ``tiled > 0`` runs the program over windows of
    ``tiled + 2 * halo`` (``validate/tiling.py``), on any scene shape at
    least one window wide.
    """
    state, kwargs = load_model_state(output_dir)
    kwargs.update({'val_disp_min': val_disp_min,
                   'val_disp_max': val_disp_max})
    cfg = Config.from_dict(kwargs)
    if cfg.model_inn:
        if val_ensamble:
            raise ValueError('val_ensamble does not apply to an INN '
                             'checkpoint (validate/cli.py rule)')
        if tiled:
            raise ValueError('tiled export does not support the INN '
                             '(per-image outputs cannot be stitched)')
    # the U-Net's and the INN's BatchNorm are not folded (nor are the
    # streams' then), as in the JAX package
    fold = not cfg.model_no_batchnorm and not cfg.model_unet and \
        not cfg.model_inn
    if fold:
        cfg = Config.from_dict({**cfg.to_dict(), 'model_no_batchnorm': True})
    model = build_model(cfg)        # raises for --model_invertible
    model.load_state_dict(fold_batchnorm(state) if fold else state,
                          strict=True)
    model.eval()

    member_offsets = None
    if calibration and calibration.get('member_offsets') is not None:
        if not val_ensamble:
            raise ValueError('calibration member_offsets only apply to an '
                             'ensemble export (--val_ensamble)')
        member_offsets = [float(x) for x in calibration['member_offsets']]

    meta = {'config': cfg.to_dict(),
            'dtype': 'bfloat16' if cfg.bf16 else 'float32',
            'val_ensamble': val_ensamble,
            'val_disp_min': val_disp_min, 'val_disp_max': val_disp_max,
            'val_disp_step': val_disp_step, 'members': members,
            'views': cfg.model_views, 'u8': u8,
            'member_offsets': member_offsets}
    if tiled:
        if cfg.model_unet:
            raise ValueError(UNET_MSG)
        halo = receptive_radius(cfg.model_ksize, cfg.model_in_blocks,
                                cfg.model_out_blocks)
        if val_ensamble:   # the member shift reaches ceil(disp)+1 further
            halo += int(np.ceil(max(abs(val_disp_min),
                                    abs(val_disp_max)))) + 1
        meta.update(tiled=tiled, halo=halo)
    if val_ensamble:
        # /healthz serves this: min-logvar selection fails silently on a
        # miscalibrated uncertainty head (validate/calibrate.py)
        meta['calibration'] = None if calibration is None else {
            'rank_corr': calibration.get('rank_corr'),
            'bare_mse': calibration.get('bare_mse'),
            'ese_mse': calibration.get('ese_mse'),
            'calibrated': calibration.get('calibrated'),
            'recalibrated': member_offsets is not None,
        }
    return model, meta


def inference_fn(model: torch.nn.Module, meta: dict):
    """The inference program of ``meta`` over ``model``, on the model's
    device: ``fn(h, v, i, d[, shift]) -> output dict``.

    The stacks may be numpy arrays or tensors; they are copied to the
    device in the call.  The call runs under ``torch.inference_mode`` on
    the caller's thread.
    """
    dev = next(model.parameters()).device
    tile, halo = int(meta.get('tiled', 0)), int(meta.get('halo', 0))
    # byte -> byte / 255 in float32, as the host decode computes it: a CUDA
    # division by a scalar multiplies by its reciprocal, an ulp off at times
    unit = torch.from_numpy(np.arange(256, dtype=np.float32) / 255.0).to(dev)

    def core(h, v, i, d):
        if meta['val_ensamble']:
            out = ensemble_forward(model, h, v, i, d,
                                   disp_min=meta['val_disp_min'],
                                   disp_max=meta['val_disp_max'],
                                   disp_step=meta['val_disp_step'],
                                   member_offsets=meta['member_offsets'])
            if not meta['members']:    # the (K, b, H, W) stacks are bulky
                out.pop('means')
                out.pop('logvars')
        else:
            out = model(h, v, i, d)
        return {k: v for k, v in out.items() if v is not None}

    @torch.inference_mode()
    def fn(h, v, i, d, shift=None):
        stacks = [torch.as_tensor(x, device=dev) for x in (h, v, i, d)]
        if meta['u8']:
            if shift is None or any(s.dtype != torch.uint8 for s in stacks):
                raise TypeError('a u8 artifact takes uint8 stacks and a '
                                'trailing shift')
            # normalize, then re-centre the whole scene before any tiling
            stacks = shift_lf(*[unit[s.int()] for s in stacks],
                              float(shift))
        if not tile:
            return core(*stacks)
        ht, wt = stacks[0].shape[2:4]
        win = tile + 2 * halo
        if ht < win or wt < win:
            raise ValueError(
                f'scene {ht}x{wt} is smaller than the tile window {win} '
                f'(tile {tile} + 2x halo {halo}); use a fixed-shape '
                f'artifact for scenes this small')
        return tiled_forward(core, stacks, tile, halo)

    return fn


def export_inference(output_dir: str, height: int, width: int,
                     val_ensamble: bool = False,
                     val_disp_min: float = -3.5, val_disp_max: float = 3.5,
                     val_disp_step: float = 0.1, members: bool = False,
                     batch: int = 1, u8: bool = False,
                     calibration: dict | None = None,
                     tiled: int = 0) -> bytes:
    """The artifact for ``(batch, views, height, width, 3)`` scenes, as
    bytes (see the module docstring); ``tiled > 0`` serves any shape at
    least one window wide (``height`` and ``width`` are ignored, ``batch``
    must be 1)."""
    if tiled and batch != 1:
        raise ValueError('tiled export supports batch=1 only (scenes of '
                         'different shapes cannot batch anyway)')
    model, meta = build_inference(
        output_dir, val_ensamble, val_disp_min, val_disp_max, val_disp_step,
        members, u8=u8, calibration=calibration, tiled=tiled)
    meta = dict(meta, batch=1 if tiled else batch,
                **({} if tiled else {'height': height, 'width': width}))
    meta_b = json.dumps(meta).encode()
    buf = io.BytesIO()
    torch.save(model.state_dict(), buf)
    weights_b = buf.getvalue()
    head = np.array([len(meta_b), len(weights_b), 0], '<u8').tobytes()
    return MAGIC + head + meta_b + weights_b


def load_exported(path_or_bytes, device='cuda'):
    """Load an artifact onto ``device``; returns ``(fn, meta)``.

    The weights go to the device once.  ``fn`` of a fixed-shape artifact
    raises ``ValueError`` on stacks of another shape or batch.  Raises
    ``RuntimeError`` when CUDA is asked for but absent, and ``ValueError``
    on a file that is not this package's artifact.
    """
    dev = resolve_device(device)
    blob = path_or_bytes
    if not isinstance(blob, (bytes, bytearray)):
        with open(blob, 'rb') as f:
            blob = f.read()
    magic = bytes(blob[:len(MAGIC)])
    if magic == JAX_MAGIC:
        raise ValueError('this is a JAX StableHLO artifact; serve the run '
                         'directory, or export it with '
                         'mmlf_tpu_torch.export')
    if magic != MAGIC or len(blob) < HEAD:
        raise ValueError('not an mmlf_tpu_torch export artifact')
    n_meta, n_weights, n_prog = (int(n) for n in np.frombuffer(
        blob[len(MAGIC):HEAD], '<u8'))
    if HEAD + n_meta + n_weights + n_prog != len(blob):
        raise ValueError('artifact size does not match its header')
    meta = json.loads(blob[HEAD:HEAD + n_meta])
    state = torch.load(io.BytesIO(blob[HEAD + n_meta:HEAD + n_meta +
                                       n_weights]),
                       map_location='cpu', weights_only=True)
    model = build_model(Config.from_dict(meta['config']))
    model.load_state_dict(state, strict=True)
    fn = inference_fn(model.to(dev).eval(), meta)
    if 'height' not in meta:
        return fn, meta

    want = (meta['batch'], meta['views'], meta['height'], meta['width'], 3)

    def fixed(h, v, i, d, *shift):
        for s in (h, v, i, d):
            if tuple(s.shape) != want:
                raise ValueError(f'artifact takes stacks of shape {want}, '
                                 f'got {tuple(s.shape)}')
        return fn(h, v, i, d, *shift)

    return fixed, meta


@click.command()
@click.argument('output_dir', type=click.Path(exists=True))
@click.argument('artifact', type=click.Path())
@click.option('--height', default=512, help='Scene height the artifact '
              'serves')
@click.option('--width', default=512, help='Scene width')
@click.option('--batch', default=1, help='Scenes per call')
@click.option('--val_ensamble', is_flag=True, help='Export the shift '
              'ensemble (ESE) program')
@click.option('--val_disp_min', default=-3.5)
@click.option('--val_disp_max', default=3.5)
@click.option('--val_disp_step', default=0.1)
@click.option('--members', is_flag=True,
              help='Keep the per-member mean/logvar stacks in the ESE '
                   'output (large)')
@click.option('--u8', is_flag=True,
              help='Low-transfer ingest: the artifact takes RAW uint8 view '
                   'stacks plus a runtime shift, and normalizes + '
                   're-centers on the device (4x less host-to-device '
                   'traffic)')
@click.option('--calibration', default=None,
              type=click.Path(exists=True, dir_okay=False),
              help='ESE calibration JSON from the validate CLI\'s '
                   '--val_save_calibration: the guard scores land in the '
                   'artifact meta (served via /healthz) and fitted member '
                   'offsets are baked into the ensemble program')
@click.option('--tiled', default=0, type=int,
              help='Tile the scene with this interior tile size, so ONE '
                   'artifact serves any scene shape at least one window '
                   'wide (--height/--width are ignored; exact for the '
                   'non-ensemble heads, the ensemble up to the '
                   'margin-masked border band)')
def main(output_dir, artifact, height, width, batch, val_ensamble,
         val_disp_min, val_disp_max, val_disp_step, members, u8,
         calibration, tiled):
    """Export a checkpoint's inference program as a serving artifact."""
    cal = None
    if calibration:
        with open(calibration) as f:
            cal = json.load(f)
    try:
        blob = export_inference(
            output_dir, height, width, val_ensamble=val_ensamble,
            val_disp_min=val_disp_min, val_disp_max=val_disp_max,
            val_disp_step=val_disp_step, members=members, u8=u8,
            batch=batch, calibration=cal, tiled=tiled)
    except ValueError as e:
        raise click.UsageError(str(e))
    with open(artifact, 'wb') as f:
        f.write(blob)
    shape = (f'any shape, tile {tiled}' if tiled
             else f'{height}x{width}')
    print(f'wrote {artifact} ({len(blob) / 1e6:.1f} MB, {shape})')


if __name__ == '__main__':
    sys.exit(main())
