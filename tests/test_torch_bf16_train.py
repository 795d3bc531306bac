"""The port's bfloat16 training options as a whole against mmlf_tpu's:
3 steps of ``train()`` with ``--bf16``, ``--bf16 --pallas_trunk`` and
``--cache_bf16`` against the JAX package's log rows, then the port's bf16
checkpoint through validate, export and serve against ``mmlf_tpu``'s.  The
modules one by one are in tests/test_torch_bf16.py, whose tolerances these
tests share.  Small nets (chs 8, 1 + 2 blocks, 32² patches)."""

import os
import shutil

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from mmlf_tpu.config import Config as JConfig
from mmlf_tpu.data.synth import generate_dataset
from mmlf_tpu.export import build_inference as j_build_inference
from mmlf_tpu.models import FeedForward as JFeedForward
from mmlf_tpu.serve import InferenceEngine as JEngine
from mmlf_tpu.train import loop as jloop
from mmlf_tpu.validate.cli import run_validation as j_run_validation
from mmlf_tpu_torch.config import Config
from mmlf_tpu_torch.export import export_inference, load_exported
from mmlf_tpu_torch.serve import InferenceEngine
from mmlf_tpu_torch.train import loop
from mmlf_tpu_torch.utils.convert import state_dict_from_jax
from mmlf_tpu_torch.validate.cli import run_validation

import torch_threads  # noqa: F401  torch's share of the CPUs under xdist

# the bf16 output tolerance of tests/test_torch_bf16.py
OUT_TOL = 2e-2


def _rel_err(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))


# ------------------------------------------------------ the slice as a whole

SLICES = {'bf16': {'bf16': True},
          'bf16_trunk': {'bf16': True, 'pallas_trunk': True},
          'cache_bf16': {'cache_bf16': True}}


@pytest.fixture(scope='module')
def slice_runs(tmp_path_factory):
    """``run(name)``: the JAX package's and the port's 3-step UPR
    ``train()`` of ``SLICES[name]`` from the same initial variables (once
    per module): ``(jax run dir, port run dir, val dir)``."""
    root = tmp_path_factory.mktemp('torch_bf16_slice')
    train_dir, val_dir = str(root / 'train'), str(root / 'val')
    generate_dataset(train_dir, scenes=2, size=64, seed=0)
    generate_dataset(val_dir, scenes=1, size=64, seed=7)
    runs = {}

    def run(name):
        if name not in runs:
            kw = dict(train_trainset=train_dir, train_valset=val_dir,
                      train_bs=4, train_ps=32, train_lr=1e-3,
                      train_max_downscale=1, val_interval=2,
                      val_loss_margin=5, train_steps=3, model_chs=8,
                      model_in_blocks=1, model_out_blocks=2,
                      model_uncert=True, **SLICES[name])
            jcfg, cfg = JConfig(**kw).finalize(), Config(**kw).finalize()
            jout, tout = str(root / f'jax_{name}'), str(root / name)
            os.makedirs(jout)
            os.makedirs(tout)
            jloop.train(jcfg, jout, progress=False)
            model = JFeedForward.from_config(jcfg)
            init = model.init(jax.random.PRNGKey(jcfg.train_seed),
                              *[jnp.zeros((1, 9, 32, 32, 3))] * 4)
            init = jax.tree_util.tree_map(np.asarray, dict(init))
            state = loop.train(cfg, tout, progress=False, device='cpu',
                               initial_state=state_dict_from_jax(init, cfg))
            assert state.step == 3
            runs[name] = (jout, tout, val_dir)
        return runs[name]
    return run


def _rows(path):
    lines = open(os.path.join(path, 'log.csv')).read().splitlines()
    assert lines[0] == loop.LOG_HEADER
    return np.array([[float(v) for v in line.split(',')]
                     for line in lines[1:]])


@pytest.mark.parametrize('name', list(SLICES))
def test_train_slice_matches_jax(slice_runs, name):
    """3 steps of ``train()`` with ``--bf16``, ``--bf16 --pallas_trunk``
    and ``--cache_bf16`` against the JAX package's log rows (train loss,
    val loss, mse, badpix at steps 0-2).  Adam's first steps move each
    weight by ~lr·sign(g), so the bf16 gradient differences of the conv
    biases (tests/test_torch_bf16.py: BIAS_TOL) reach the parameters at the scale of lr: the
    rows within 5e-3, relative (2e-3 measured)."""
    jout, tout, _ = slice_runs(name)
    want, got = _rows(jout), _rows(tout)
    assert got[:, 0].tolist() == want[:, 0].tolist() == [0, 1, 2]
    np.testing.assert_allclose(got[:, 1:5], want[:, 1:5], rtol=5e-3)


def test_bf16_checkpoint_validates_exports_serves(slice_runs, tmp_path):
    """The port's bf16 checkpoint (``hyper_parameters`` with ``bf16``)
    through the port's validate CLI (whole and tiled ESE at 7 members),
    export and server, against ``mmlf_tpu.validate`` / ``mmlf_tpu.export``
    / ``mmlf_tpu.serve`` on the same ``checkpoint.pt``: both evaluate the
    BN-folded weights with the bf16 trunk.  The trunks agree to a bf16
    rounding here and there, and a member's selection can flip where two
    logvars nearly tie: the metrics within 1e-2 relative, the served
    outputs within 2e-2 of their largest magnitude.  The artifact records
    the trunk's dtype and runs in it."""
    _, run, val_dir = slice_runs('bf16')
    runs = []
    for who in ('jax', 'torch', 'torch_tiled'):
        runs.append(str(tmp_path / who))
        shutil.copytree(run, runs[-1])
    kw = dict(val_loss_margin=15, val_ensamble=True, val_disp_step=1.0)
    want = j_run_validation(runs[0], val_dir, **kw)
    got = run_validation(runs[1], val_dir, device='cpu', **kw)
    tiled = run_validation(runs[2], val_dir, device='cpu', val_tile=32, **kw)
    for k in ('mse', 'badpix', 'kld', 'nll'):
        assert np.isfinite(got[k]) and np.isfinite(tiled[k]), k
        assert got[k] == pytest.approx(want[k], rel=1e-2, abs=1e-6), k

    fn, meta = load_exported(export_inference(run, 64, 64), device='cpu')
    assert meta['dtype'] == 'bfloat16' and meta['config']['bf16']
    rng = np.random.default_rng(3)
    stacks = [rng.random((1, 9, 64, 64, 3), dtype=np.float32)
              for _ in range(4)]
    out = {k: v.numpy() for k, v in fn(*stacks).items()}
    fwd, variables, _ = j_build_inference(run)
    jout = {k: np.asarray(v) for k, v in jax.jit(fwd)(variables,
                                                     *stacks).items()}
    for k in ('mean', 'logvar'):
        assert _rel_err(out[k], jout[k]) <= OUT_TOL, k

    scene = os.path.join(val_dir, 'scene_00')
    got = InferenceEngine(run, device='cpu').infer(scene, train_shift=0.5)
    want = JEngine(run).infer(scene, train_shift=0.5)
    for k in ('mse', 'badpix_007'):
        assert got[k] == pytest.approx(want[k], rel=1e-2, abs=1e-6), k
