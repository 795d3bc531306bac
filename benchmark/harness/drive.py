"""The one generator of the benchmark's traffic: it reads a cell's
configuration and traffic mix (data files) and drives the program, the
PyTorch port ``mmlf_tpu_torch``, through set-up, warm-up and the measured
window; then it hands the program's outputs to ``check.py``.

Traffic kinds:

* ``train``: the training set is made in memory from the seed and handed
  to the port's ``DevicePipeline``; every step is ``sample_batch`` then
  ``train_step`` (forward, backward, Adam), back to back, each loss read
  ``log_lag`` steps behind as the port's train loop reads it.  The first
  ``checked_steps`` steps are the warm-up and the steps the reference
  follows.
* ``ese``: the val set is written to files under ``TMPDIR`` and a
  checkpoint of the seeded weights beside it; every unit of work is one
  ``run_validation(..., val_ensamble=True)`` pass over the val set, which
  loads each scene, runs the shift ensemble, scores it and writes its
  artifacts.
"""

from __future__ import annotations

import contextlib
import io
import os
import shutil
import tempfile
import time

import numpy as np
import torch

from . import check, nets, synth, weights
from .trace import WINDOW, Spans, Trace, start_profiler, stop_profiler


class Run:
    """What one run produced: the window's work and time, the program's
    outputs for the check, the trace and the spans."""

    def __init__(self, cell, config, traffic, seed, seconds, traced, device):
        self.cell, self.config, self.traffic = cell, config, traffic
        self.seed, self.seconds, self.traced = seed, seconds, traced
        self.device = torch.device(device)
        self.net = nets.load(config)
        self.spans = Spans(traced)
        self.trace = None
        self.units = 0            # steps or scenes in the window
        self.failed = 0
        self.window_s = 0.0
        self.setup_s = 0.0
        self.window_peak = 0
        self.memory_peak = 0
        self.launches = {}
        self.checks = {}


def _counts():
    from mmlf_tpu_torch.ops.kernels import launch_counts
    return launch_counts()


def _sync(dev):
    if dev.type == 'cuda':
        torch.cuda.synchronize(dev)


def _peak(dev) -> int:
    return torch.cuda.max_memory_allocated(dev) if dev.type == 'cuda' else 0


def _reset_peak(dev):
    if dev.type == 'cuda':
        torch.cuda.reset_peak_memory_stats(dev)


def _rng(seed: int, stream: int):
    return np.random.default_rng([int(seed), stream])


def port_config(config: dict):
    """The port's ``Config`` of a configuration file."""
    from mmlf_tpu_torch.config import Config
    return Config.from_dict(config['port_config']).finalize()


# ------------------------------------------------------------------- train

class InMemoryScenes:
    """The scene list ``TrainPipeline`` reads from a cached ``HCI4D``:
    9-tuples ``(h, v, i, d, center, gt, mpi, mask, index)`` of numpy
    arrays."""
    cache = True

    def __init__(self, data):
        self.data = data


def train_scenes(traffic: dict, seed: int, dev, with_mpi: bool):
    """The training set: ``(tuples for the port, (stacks, gt, mpi, mask)
    on the device for the reference)``; the reference's MPI is None unless
    ``with_mpi`` (a net whose loss reads it), so that no other cell holds
    it on the device."""
    made = synth.generate(_rng(seed, 1), traffic['scenes'],
                          traffic['scene_size'], dev,
                          traffic['disp_range'], traffic['disp_center'],
                          traffic['layers'],
                          views=sum(synth.cross_indices(), []))
    tuples, ref = [], []
    for j, (views, gt, mpi) in enumerate(made):
        stacks = synth.stacks_of(views)
        center = stacks[1][synth.GRID // 2]
        mask = synth.texture_mask(center)
        tuples.append(tuple(s.cpu().numpy() for s in stacks) + (
            center.cpu().numpy(), gt.cpu().numpy(), mpi.cpu().numpy(),
            mask.cpu().numpy(), np.atleast_1d(j)))
        ref.append((stacks, gt, mpi if with_mpi else None, mask))
    return tuples, ref


def run_train(run: Run):
    from mmlf_tpu_torch.data.pipeline import DevicePipeline
    from mmlf_tpu_torch.models import build_model
    from mmlf_tpu_torch.train import loop
    from mmlf_tpu_torch.utils.device import resolve_device

    # the train entry's device rules: CUDA, and TF32 off
    dev, traffic = resolve_device(run.device), run.traffic
    cfg = port_config(run.config)
    with run.spans('setup.scenes'):
        tuples, ref_scenes = train_scenes(traffic, run.seed, dev,
                                          run.net.USES_MPI)
    with run.spans('setup.model'):
        sd0 = weights.make_state_dict(run.net, run.config['port_config'],
                                      run.seed, dev)
        model = build_model(cfg)
        model.load_state_dict(sd0, strict=True)
        model.to(dev)
        optimizer = loop.make_optimizer(model)
    with run.spans('setup.pipeline'):
        pipeline = DevicePipeline(InMemoryScenes(tuples), cfg,
                                  seed=int(_rng(run.seed, 2).integers(2**62)),
                                  device=dev)
    del tuples
    bs, lag = cfg.train_bs, int(traffic['log_lag'])
    def one_step(i):
        with run.spans('sample'):
            batch = pipeline.sample_batch(bs)
        with run.spans('train_step'):
            loss = loop.train_step(cfg, model, optimizer, pipeline.cache,
                                   batch, i)
        return batch, loss

    # the warm-up: the steps the reference follows, through the window's
    # own call and feed
    batches, losses = [], []
    first_grads = None
    warm = run.spans('setup.checked_steps')
    warm.__enter__()
    for i in range(int(traffic['checked_steps'])):
        batch, loss = one_step(i)
        batches.append(batch)
        losses.append(loss)
        if i == 0:
            # the first gradient as Adam got it: exp_avg = (1 - β1)·g
            first_grads = {
                k: optimizer.state[p]['exp_avg'].detach().clone() / 0.1
                for k, p in model.named_parameters()}
    state = {k: v.detach().clone() for k, v in model.state_dict().items()}
    losses = [float(x) for x in losses]
    _sync(dev)
    warm.__exit__(None, None, None)
    run.setup_s = time.perf_counter() - run.t_start
    run.memory_peak = _peak(dev)

    # the window
    i = len(batches)
    before = _counts()
    _reset_peak(dev)
    prof = start_profiler() if run.traced else None
    pending = []
    with run.spans(WINDOW):
        t0 = time.perf_counter()
        while True:
            _, loss = one_step(i)
            i += 1
            pending.append(loss)
            if len(pending) > lag and \
                    not np.isfinite(float(pending.pop(0))):
                run.failed += 1
            if time.perf_counter() - t0 >= run.seconds:
                break
        for loss in pending:
            if not np.isfinite(float(loss)):
                run.failed += 1
        _sync(dev)
        run.window_s = time.perf_counter() - t0
    if prof is not None:
        run.trace = Trace(stop_profiler(prof))
    run.units = i - len(batches)
    run.launches = {k: v - before[k] for k, v in _counts().items()}
    run.window_peak = _peak(dev)
    run.memory_peak = max(run.memory_peak, run.window_peak)

    run.program = {'losses': losses, 'grads': first_grads, 'state': state}
    del model, optimizer, pipeline, first_grads
    _empty(dev)
    run.ref_inputs = (sd0, ref_scenes, batches)
    run.reference = check.train_reference_run(run.config, sd0, ref_scenes,
                                              batches, dev)
    run.checks = check.compare_train(run.program, run.reference, sd0)


def _empty(dev):
    import gc
    gc.collect()
    if dev.type == 'cuda':
        torch.cuda.empty_cache()


# --------------------------------------------------------------------- ese

def _write_scene(root: str, views: dict, gt, mpi, pool):
    """A scene directory as the HCI loader reads it: 81 PNG views, the
    gt PFM (bottom-up) and the MPI (``(H, W, K, 5)`` bottom-up)."""
    from PIL import Image
    os.makedirs(root)
    jobs = [pool.submit(lambda a, p: Image.fromarray(a).save(p),
                        views[idx].cpu().numpy(),
                        os.path.join(root, f'input_Cam{idx:03d}.png'))
            for idx in range(synth.GRID * synth.GRID)]
    write_pfm(os.path.join(root, 'gt_disp_lowres.pfm'),
              np.flip(gt.cpu().numpy(), 0))
    mpi_file = np.flip(np.transpose(mpi.cpu().numpy(), (1, 2, 0, 3)), 0)
    np.savez(os.path.join(root, 'gt_mpi_lowres.npz'),
             mpi=np.ascontiguousarray(mpi_file))
    for j in jobs:
        j.result()


def write_pfm(path: str, image: np.ndarray) -> None:
    """A float32 ``(H, W)`` array as a little-endian PFM."""
    image = np.ascontiguousarray(image, dtype='<f4')
    with open(path, 'wb') as f:
        f.write(b'Pf\n' + f'{image.shape[1]} {image.shape[0]}\n'.encode()
                + b'-1.000000\n')
        image.tofile(f)


def read_pfm(path: str) -> np.ndarray:
    """A one-channel PFM as float32 ``(H, W)``, rows as stored."""
    with open(path, 'rb') as f:
        if f.readline().strip() != b'Pf':
            raise ValueError(f'{path}: not a one-channel PFM')
        w, h = (int(x) for x in f.readline().split())
        scale = float(f.readline())
        data = np.fromfile(f, dtype='<f4' if scale < 0 else '>f4',
                           count=w * h)
    return data.reshape(h, w).astype(np.float32)


def _scene_lines(text: str) -> dict:
    """The per-scene metric lines ``run_validation`` prints: scene index →
    ``{mse, bad_pix, kld_um, kld_mm, kld}``."""
    out, scene, rows = {}, None, []
    for line in text.splitlines():
        if line.startswith('Processing scene '):
            scene, rows = int(line.split()[2].rstrip('.')), []
            continue
        if scene is None:
            continue
        try:
            rows.append([float(x) for x in line.split()])
        except ValueError:
            continue
        if len(rows) == 2:
            (mse, bad), (um, mm, kld) = rows
            out[scene] = {'mse': mse, 'bad_pix': bad, 'kld_um': um,
                          'kld_mm': mm, 'kld': kld}
            scene = None
    return out


def _spanned(spans, name, fn):
    """``fn`` inside a span called ``name``."""
    def wrapper(*a, **k):
        with spans(name):
            return fn(*a, **k)
    return wrapper


def run_ese(run: Run):
    from concurrent.futures import ThreadPoolExecutor

    from mmlf_tpu_torch.models import ensemble as E
    from mmlf_tpu_torch.utils.convert import save_checkpoint_pt
    from mmlf_tpu_torch.validate import cli as V

    if not run.net.ESE:
        raise ValueError(
            f'{run.cell["name"]}: the ese traffic validates with the shift '
            f'ensemble, which selects members by their mean and logvar; net '
            f'{run.config.get("net", nets.DEFAULT)!r} gives no such outputs '
            f'(ESE false in its module)')
    dev, traffic = run.device, run.traffic
    cfg = port_config(run.config)
    n, size = traffic['scenes'], traffic['scene_size']
    scenes_span = run.spans('setup.scenes')
    scenes_span.__enter__()
    # every seed validates the same scenes (their PNG coding and the host's
    # work depend on their content), in an order and with weights drawn
    # from the seed
    made = synth.generate(_rng(traffic['scene_seed'], 1), n, size, dev,
                          traffic['disp_range'], traffic['disp_center'],
                          traffic['layers'])
    made = [made[j] for j in _rng(run.seed, 4).permutation(n)]
    root = tempfile.mkdtemp(prefix='mmlf-bench-')
    try:
        val, warm, out = (os.path.join(root, d) for d in
                          ('val', 'warm', 'run'))
        os.makedirs(warm)
        os.makedirs(out)
        with ThreadPoolExecutor(8) as pool:
            for j, (views, gt, mpi) in enumerate(made):
                _write_scene(os.path.join(val, f'scene_{j:02d}'), views, gt,
                             mpi, pool)
        os.symlink(os.path.join(val, 'scene_00'),
                   os.path.join(warm, 'scene_00'))
        scenes_span.__exit__(None, None, None)
        shift = float(traffic['train_shift'])
        sd = weights.make_state_dict(run.net, run.config['port_config'],
                                     run.seed, dev)
        # the running statistics from the warm scene (scene 0)
        check.calibrate_bn(run.config, sd,
                           check.shifted_stacks(made[0][0], shift), dev)
        save_checkpoint_pt(os.path.join(out, 'checkpoint.pt'),
                           {k: v.cpu() for k, v in sd.items()}, cfg)
        kw = dict(val_ensamble=True, train_shift=shift,
                  val_disp_min=traffic['disp_min'],
                  val_disp_max=traffic['disp_max'],
                  val_disp_step=traffic['disp_step'], device=dev)

        members = {'n': 0}
        forward = V.ensemble_forward
        posterior = E.ensemble_posterior

        def traced_forward(*a, **k):
            with run.spans('ensemble_forward'):
                res = forward(*a, **k)
                if run.traced:
                    # the span ends when the members' work is done
                    _sync(dev)
            members['n'] += len(E.ensemble_grid(k['disp_min'],
                                                k['disp_max'],
                                                k['disp_step']))
            return res

        def traced_posterior(*a, **k):
            with run.spans('posterior'):
                return posterior(*a, **k)

        from mmlf_tpu_torch.data.hci4d import HCI4D
        from mmlf_tpu_torch.validate import calibrate as K
        wrapped = [(V, 'ensemble_forward', traced_forward),
                   (E, 'ensemble_posterior', traced_posterior)]
        for owner, attr, name in ((HCI4D, '__getitem__', 'load'),
                                  (HCI4D, 'save_batch', 'save'),
                                  (K, 'scene_calibration', 'calibration'),
                                  (V, 'load_model_state', 'load_model')):
            wrapped.append((owner, attr, _spanned(run.spans, name,
                                                  getattr(owner, attr))))
        kept = [(owner, attr, getattr(owner, attr))
                for owner, attr, _ in wrapped]
        for owner, attr, fn in wrapped:
            setattr(owner, attr, fn)
        text = io.StringIO()
        try:
            with contextlib.redirect_stdout(text), \
                    run.spans('setup.warm_scene'):
                V.run_validation(out, warm, **kw)
            _sync(dev)
            run.setup_s = time.perf_counter() - run.t_start
            run.memory_peak = _peak(dev)
            before = _counts()
            members['n'] = 0
            _reset_peak(dev)
            prof = start_profiler() if run.traced else None
            passes = 0
            with run.spans(WINDOW):
                t0 = time.perf_counter()
                while True:
                    text = io.StringIO()
                    with contextlib.redirect_stdout(text):
                        V.run_validation(out, val, **kw)
                    passes += 1
                    # a scene whose report is missing or not finite failed
                    reported = _scene_lines(text.getvalue())
                    run.failed += sum(
                        1 for j in range(n) if j not in reported or not
                        all(np.isfinite(v) for v in reported[j].values()))
                    if time.perf_counter() - t0 >= run.seconds:
                        break
                _sync(dev)
                run.window_s = time.perf_counter() - t0
        finally:
            for owner, attr, fn in kept:
                setattr(owner, attr, fn)
        if prof is not None:
            run.trace = Trace(stop_profiler(prof))
        run.units = passes * n
        run.members = members['n']
        run.launches = {k: v - before[k] for k, v in _counts().items()}
        run.window_peak = _peak(dev)
        run.memory_peak = max(run.memory_peak, run.window_peak)

        j = int(_rng(run.seed, 3).integers(n))
        scene_dir = os.path.join(out, 'scenes', f'scene_{j:02d}')
        run.program = {
            'gmm': np.load(os.path.join(scene_dir, 'gmm.npy')),
            'posterior': np.load(os.path.join(scene_dir, 'posterior.npy')),
            'result': np.flip(read_pfm(os.path.join(scene_dir,
                                                    'result.pfm')), 0),
            'uncert_scale': np.exp(np.flip(read_pfm(os.path.join(
                scene_dir, 'uncert.pfm')), 0)),
            'metrics': reported.get(j)}
        _empty(dev)
        views, gt, mpi = made[j]
        run.ref_inputs = (sd, check.shifted_stacks(views, shift),
                          gt - np.float32(shift), mpi)
        run.reference = check.ese_reference_run(run.config, *run.ref_inputs,
                                                traffic, dev)
        run.checks = check.compare_ese(run.program, run.reference)
    finally:
        shutil.rmtree(root, ignore_errors=True)


KINDS = {'train': run_train, 'ese': run_ese}


def run_cell(cell: dict, config: dict, traffic: dict, seed: int,
             seconds: float, traced: bool, device='cuda',
             t_start: float | None = None) -> Run:
    """One run of a cell; ``t_start`` is when the process started (set-up
    counts from there)."""
    run = Run(cell, config, traffic, seed, seconds, traced, device)
    run.t_start = time.perf_counter() if t_start is None else t_start
    KINDS[traffic['kind']](run)
    return run
