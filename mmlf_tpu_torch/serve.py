"""Inference server.

``python -m mmlf_tpu_torch.serve MODEL [--port 8417] [--device cuda]``
serves light-field depth inference over HTTP from either

* an export artifact (``mmlf_tpu_torch.export``: fixed scene shape and
  batch, or any shape with ``--tiled``), or
* a run directory (the JAX package's ``checkpoint.msgpack`` or a
  reference-format ``checkpoint.pt``: any shape and batch).

The port of ``mmlf_tpu.serve``, with its endpoints, checks and flags but
``--jax_cache`` (nothing is compiled per shape here), plus ``--device``.
The weights live on the device from startup on.

Endpoints (JSON; stdlib http.server):
  GET  /healthz  -> model/meta info (with the ESE calibration status)
  GET  /stats    -> request counters + latency aggregates
  POST /infer    {"scene_dir": DIR[, "out_dir": DIR][, "train_shift": S]}
                 or {"scene_dirs": [DIR, ...], ...} for a batched call
                 -> disparity statistics (+ masked MSE / BadPix(0.07) on
                 the margin-15 mask when the scene ships GT), ``runtime_s``
                 and the artifact paths written (``result.pfm`` /
                 ``uncert.pfm``, bottom-up like the reference writer).
                 Multi-scene requests write per-scene subdirectories of
                 ``out_dir`` and return a ``scenes`` list.

``runtime_s`` is the device call, from the numpy stacks to the ``mean``
on the host: the host-to-device copy of the stacks is inside it, which is
what ``--u8`` ingest (raw uint8 views, normalized and re-centred on the
device) cuts by 4x.  Device calls are serialized with a lock.

The server binds loopback by default and has NO authentication; if exposed
beyond localhost (``--host``), set ``--data_root`` so scene/output paths are
confined to one directory tree.
"""

from __future__ import annotations

import json
import os
import sys
import threading
import time
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import click
import numpy as np
import torch

from .data import transforms as T
from .data.hci4d import _pick_gt_pfm, load_scene
from .export import build_inference, inference_fn, load_exported
from .losses import masked_badpix, masked_mse
from .ops.masks import create_mask_margin
from .utils import pfm
from .utils.device import resolve_device


class InferenceEngine:
    """Owns the model (artifact or run directory) on the device and runs
    scenes through it."""

    def __init__(self, model_path: str, val_ensamble: bool = False,
                 train_shift: float = 0.0, data_root: str = '',
                 u8: bool = False, decode_threads: int = 8,
                 calibration: str = '', device='cuda'):
        self.device = resolve_device(device)
        self.train_shift = float(train_shift)
        self.decode_threads = int(decode_threads)
        self.data_root = (os.path.realpath(data_root) if data_root else '')
        self.lock = threading.Lock()           # serializes device calls
        self.stats_lock = threading.Lock()     # guards the counters
        self.stats = {'requests': 0, 'errors': 0, 'total_s': 0.0,
                      'last_s': None}
        self.fixed_shape = None
        self.fixed_batch = None                # artifact mode only
        if os.path.isdir(model_path):
            cal = None
            if calibration:
                with open(calibration) as f:
                    cal = json.load(f)
            model, self.meta = build_inference(
                model_path, val_ensamble=val_ensamble, u8=u8,
                calibration=cal)
            self._call = inference_fn(model.to(self.device), self.meta)
        else:
            self._call, self.meta = load_exported(model_path, self.device)
            if not self.meta.get('tiled'):
                self.fixed_shape = (self.meta['height'], self.meta['width'])
            self.fixed_batch = int(self.meta.get('batch', 1))
            if u8 and not self.meta.get('u8', False):
                # --u8 cannot change an fp32 artifact's ingest; failing
                # loudly beats silently serving at fp32 transfer cost
                raise ValueError(
                    'artifact was not exported with --u8; re-export with '
                    'mmlf_tpu_torch.export --u8 (artifacts carry the '
                    'ingest mode in their meta)')
        self.u8 = bool(self.meta.get('u8', False))
        self.tiled = int(self.meta.get('tiled', 0))
        self.views = int(self.meta['views'])

    def warmup(self, size: int = 0):
        """One call before the first request (cuDNN's first-call set-up),
        at the artifact's shape or at ``size``² (0 = skip, unless the
        artifact has a fixed shape)."""
        if self.fixed_shape:
            h, w = self.fixed_shape
        elif size:
            h = w = int(size)
        else:
            return None
        z = np.zeros((self.fixed_batch or 1, self.views, h, w, 3),
                     np.uint8 if self.u8 else np.float32)
        args = [z, z, z, z] + ([0.0] if self.u8 else [])
        with self.lock:
            self._call(*args)['mean'].cpu()
        return h, w

    def _check_root(self, path: str, what: str) -> str:
        if self.data_root:
            real = os.path.realpath(path)
            if os.path.commonpath([real, self.data_root]) != self.data_root:
                raise ValueError(f'{what} {path!r} is outside --data_root')
        return path

    def infer(self, scene_dir: str | None = None,
              out_dir: str | None = None,
              train_shift: float | None = None,
              scene_dirs: list | None = None) -> dict:
        single = scene_dirs is None
        if single:
            if not scene_dir:
                raise ValueError('scene_dir (or scene_dirs) is required')
            scene_dirs = [scene_dir]
        elif not isinstance(scene_dirs, (list, tuple)) or not scene_dirs \
                or not all(isinstance(s, str) for s in scene_dirs):
            raise ValueError('scene_dirs must be a non-empty list of paths')
        if out_dir:
            self._check_root(out_dir, 'out_dir')

        shift = self.train_shift if train_shift is None else float(train_shift)
        nviews = (self.views, self.views)
        samples = []
        for sd in scene_dirs:
            self._check_root(sd, 'scene_dir')
            # the 23x23 texture mask is never used here: skip its cost
            sample = load_scene(sd, nviews=nviews, texture_mask=False,
                                raw_views=self.u8,
                                threads=self.decode_threads)
            if self.u8:
                if shift != 0.0:
                    # the stacks stay uint8 (the device shifts them); GT
                    # and the MPI disparity channel are corrected here, as
                    # T.Shift does
                    mpi = sample[6].copy()
                    mpi[..., 4] -= np.float32(shift)
                    sample = sample[:5] + (sample[5] - np.float32(shift),
                                           mpi) + sample[7:]
            elif shift != 0.0:
                sample = T.Shift(shift)(sample)
            samples.append(sample)

        shapes = {s[0].shape for s in samples}
        if len(shapes) > 1:
            raise ValueError('scenes in one request must share a shape, '
                             f'got {sorted(map(str, shapes))}')
        spatial = samples[0][0].shape[1:3]
        if self.fixed_shape and spatial != self.fixed_shape:
            raise ValueError(
                f'artifact is specialized to {self.fixed_shape}, scene is '
                f'{spatial} — export at this shape or serve the '
                f'run directory instead')
        n = len(samples)
        if self.fixed_batch is not None and n > self.fixed_batch:
            raise ValueError(f'artifact batch is {self.fixed_batch}, '
                             f'request has {n} scenes')

        def batch_stack(j):
            arr = np.stack([s[j] for s in samples])
            if self.fixed_batch and arr.shape[0] < self.fixed_batch:
                pad = np.zeros((self.fixed_batch - arr.shape[0],)
                               + arr.shape[1:], arr.dtype)
                arr = np.concatenate([arr, pad])
            return arr

        args = [batch_stack(j) for j in range(4)]
        if self.u8:
            args.append(shift)
        # grad mode is thread-local, and every request runs on a thread of
        # its own: inference mode is entered here, not once at startup
        t0 = time.time()
        with self.lock, torch.inference_mode():
            out = self._call(*args)
            mean = out['mean'][:n].cpu().numpy()
        runtime = time.time() - t0
        logvar = out.get('logvar')
        logvar = None if logvar is None else logvar[:n].cpu().numpy()

        resps = []
        for k, (sd, sample) in enumerate(zip(scene_dirs, samples)):
            gt = sample[5]
            mk = mean[k]
            resp = {
                'scene': os.path.basename(os.path.abspath(sd)),
                'shape': list(mk.shape),
                'disp': {'min': float(mk.min()), 'max': float(mk.max()),
                         'mean': float(mk.mean())},
            }
            if _pick_gt_pfm(sd, nviews) is not None:
                gt_t = torch.from_numpy(np.ascontiguousarray(gt[None]))
                m = create_mask_margin(gt_t.shape, 15)
                out_d = {'mean': torch.from_numpy(mk[None])}
                resp['mse'] = float(masked_mse(out_d, gt_t, m))
                resp['badpix_007'] = float(masked_badpix(out_d, gt_t, m))
            if out_dir:
                dst = out_dir if single else os.path.join(out_dir,
                                                          resp['scene'])
                os.makedirs(dst, exist_ok=True)
                rp = os.path.join(dst, 'result.pfm')
                pfm.save(rp, np.flip(mk.astype(np.float32), 0).copy())
                resp['artifacts'] = [rp]
                if logvar is not None:
                    up = os.path.join(dst, 'uncert.pfm')
                    pfm.save(up, np.flip(
                        logvar[k].astype(np.float32), 0).copy())
                    resp['artifacts'].append(up)
            resps.append(resp)

        if single:
            return dict(resps[0], runtime_s=round(runtime, 4))
        return {'runtime_s': round(runtime, 4), 'scenes': resps}


def make_server(engine: InferenceEngine, host: str = '127.0.0.1',
                port: int = 8417) -> ThreadingHTTPServer:

    class Handler(BaseHTTPRequestHandler):
        def log_message(self, fmt, *args):   # quiet; /stats has the numbers
            pass

        def _send(self, code: int, payload: dict):
            body = json.dumps(payload).encode()
            self.send_response(code)
            self.send_header('Content-Type', 'application/json')
            self.send_header('Content-Length', str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def do_GET(self):
            if self.path == '/healthz':
                cfg = engine.meta.get('config', {})
                payload = {
                    'status': 'ok',
                    'fixed_shape': engine.fixed_shape,
                    'val_ensamble': engine.meta.get('val_ensamble', False),
                    'model': {k: cfg.get(k) for k in
                              ('model_chs', 'model_uncert', 'model_discrete',
                               'model_unet', 'model_views')},
                }
                if payload['val_ensamble']:
                    # min-logvar member selection fails SILENTLY on a
                    # miscalibrated uncertainty head (validate/calibrate.py)
                    # — an ensemble that was never checked must say so
                    cal = engine.meta.get('calibration')
                    payload['calibration'] = cal if cal is not None else {
                        'status': 'unchecked',
                        'hint': 'run the validate CLI with --val_ensamble '
                                '--val_save_calibration and re-export with '
                                '--calibration (or serve --calibration)',
                    }
                self._send(200, payload)
            elif self.path == '/stats':
                with engine.stats_lock:
                    s = dict(engine.stats)
                n = max(1, s['requests'] - s['errors'])
                s['avg_s'] = round(s['total_s'] / n, 4)
                self._send(200, s)
            else:
                self._send(404, {'error': f'unknown path {self.path}'})

        def do_POST(self):
            if self.path != '/infer':
                self._send(404, {'error': f'unknown path {self.path}'})
                return
            with engine.stats_lock:
                engine.stats['requests'] += 1
            try:
                ln = int(self.headers.get('Content-Length', 0))
                req = json.loads(self.rfile.read(ln) or b'{}')
                if not isinstance(req, dict):
                    raise ValueError('request body must be a JSON object')
                resp = engine.infer(req.get('scene_dir'),
                                    req.get('out_dir'),
                                    req.get('train_shift'),
                                    req.get('scene_dirs'))
                with engine.stats_lock:
                    engine.stats['total_s'] += resp['runtime_s']
                    engine.stats['last_s'] = resp['runtime_s']
                self._send(200, resp)
            except (KeyError, TypeError, ValueError, OSError) as e:
                with engine.stats_lock:
                    engine.stats['errors'] += 1
                self._send(400, {'error': f'{type(e).__name__}: {e}'})

    return ThreadingHTTPServer((host, port), Handler)


@click.command()
@click.argument('model', type=click.Path(exists=True))
@click.option('--host', default='127.0.0.1')
@click.option('--port', default=8417)
@click.option('--val_ensamble', is_flag=True,
              help='Run-directory mode: serve the shift ensemble')
@click.option('--u8', is_flag=True,
              help='Run-directory mode: low-transfer ingest — ship raw '
                   'uint8 views and normalize + re-center on the device '
                   '(artifacts carry this in their meta instead)')
@click.option('--train_shift', default=0.0, type=float,
              help='Default static re-centering shift applied to scenes')
@click.option('--decode_threads', default=8,
              help='Thread-pool size for the per-scene PNG view decode '
                   '(PIL releases the GIL; 0 = serial)')
@click.option('--data_root', default='', type=click.Path(),
              help='Confine scene_dir/out_dir paths to this directory tree '
                   '(REQUIRED whenever --host is not loopback; the API has '
                   'no authentication)')
@click.option('--calibration', default=None,
              type=click.Path(exists=True, dir_okay=False),
              help='Run-directory ensemble mode: ESE calibration JSON '
                   'from the validate CLI (--val_save_calibration); guard '
                   'scores show on /healthz, fitted member offsets apply '
                   'to selection/posterior')
@click.option('--warmup_size', default=0,
              help='Run-directory mode: one call at this scene size at '
                   'startup (artifacts always warm up at their shape)')
@click.option('--no_warmup', is_flag=True,
              help='Skip the startup call')
@click.option('--device', default='cuda',
              help='Torch device to serve on (default cuda; raises when '
                   'CUDA is absent — pass cpu to run on the CPU).')
def main(model, host, port, val_ensamble, u8, train_shift, decode_threads,
         data_root, calibration, warmup_size, no_warmup, device):
    """Serve depth inference from an export artifact or run directory."""
    if host not in ('127.0.0.1', 'localhost', '::1') and not data_root:
        # an unauthenticated API that reads/writes caller-supplied paths
        # must not face a network without path confinement
        raise click.UsageError(
            f'--host {host} is not loopback: the API has no '
            f'authentication, so --data_root is required to confine '
            f'scene/output paths')
    engine = InferenceEngine(model, val_ensamble=val_ensamble,
                             train_shift=train_shift, data_root=data_root,
                             u8=u8, decode_threads=decode_threads,
                             calibration=calibration, device=device)
    if not no_warmup:
        shape = engine.warmup(warmup_size)
        if shape:
            print(f'warmed up at {shape[0]}x{shape[1]}')
    server = make_server(engine, host, port)
    print(f'serving {model} on http://{host}:{server.server_address[1]}')
    try:
        server.serve_forever()
    except KeyboardInterrupt:
        pass
    finally:
        server.server_close()


if __name__ == '__main__':
    sys.exit(main())
