"""The port's sharded validation (``--mesh_ensemble``, ``--mesh_space``)
against the JAX package's.  Two gloo ranks on the CPU, spawned by
``parallel/mesh.launch`` under a timeout and meeting through a file store
under ``tmp_path``, run every case in one group
(``tests/torch_mesh_val_ranks.py``: torch and the port only); the JAX
oracle runs here on the 8 host devices tests/conftest.py forces, with a
2-device mesh.  Cases: ``ensemble_forward_sharded`` with and without the
member stacks and with offsets, on the 70-member grid and on the padded
47-member grid of ``--val_disp_step 0.15``, and on a forced logvar tie;
then ``run_validation`` with ``mesh_ensemble=2`` / ``mesh_space=2``, with
and without the ensemble (14 members) and recalibration, on a UPR, an INN
and a U-Net checkpoint.  Also the usage rules and the too-few-devices behaviour."""

import json
import os
import shutil

import click
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mmlf_tpu.config import Config as JConfig
from mmlf_tpu.data.synth import generate_dataset
from mmlf_tpu.models import FeedForward as JFeedForward
from mmlf_tpu.models.ensemble import \
    ensemble_forward_sharded as j_ensemble_sharded
from mmlf_tpu.models.inn import INN as JINN
from mmlf_tpu.parallel.mesh import make_mesh
from mmlf_tpu.train import checkpoint as jckpt
from mmlf_tpu.utils import pfm
from mmlf_tpu.utils.convert import torch_state_to_flax
from mmlf_tpu.validate.cli import run_validation as j_run_validation
from mmlf_tpu_torch.config import Config
from mmlf_tpu_torch.models.ensemble import ensemble_forward
from mmlf_tpu_torch.models.feed_forward import FeedForward, init_live_
from mmlf_tpu_torch.parallel import mesh
from mmlf_tpu_torch.utils.convert import state_dict_from_jax
from mmlf_tpu_torch.validate.cli import run_validation

import torch_mesh_val_ranks
import torch_threads  # noqa: F401  torch's share of the CPUs under xdist
from test_torch_validate import _checkpoint

RANKS = 2
TIMEOUT_S = 240     # the one run of the ranks; a hung run fails, never hangs
MODEL = dict(model_chs=6, model_views=3, model_in_blocks=1,
             model_out_blocks=2, model_uncert=True)
METRICS = torch_mesh_val_ranks.METRICS
# ensemble case -> (grid step, need_members, offsets, tie)
ENSEMBLE_CASES = {'members': (0.1, True, False, False),
                  'no_members_offsets': (0.1, False, True, False),
                  'padded_offsets': (0.15, True, True, False),
                  'tie': (0.1, True, False, True)}
# the validate cases' member grid: 14 members keep the CPU runs short (the
# grid's size and padding are the ensemble cases' concern)
VAL_DISP_STEP = 0.5
# validate case -> (checkpoint, keyword arguments)
VALIDATE_CASES = {
    'ens_mesh_ensemble': ('upr', dict(val_ensamble=True, mesh_ensemble=2)),
    'ens_recal_mesh_ensemble': ('upr', dict(val_ensamble=True,
                                            mesh_ensemble=2,
                                            val_recalibrate=True)),
    'upr_mesh_space': ('upr', dict(mesh_space=2)),
    'ens_mesh_space': ('upr', dict(val_ensamble=True, mesh_space=2)),
    'ens_recal_mesh_space': ('upr', dict(val_ensamble=True, mesh_space=2,
                                         val_recalibrate=True)),
    'inn_mesh_space': ('inn', dict(mesh_space=2)),
    'unet_mesh_space': ('unet', dict(mesh_space=2)),
}


def _tie_apply(_variables, h, v, i, d):
    mean = jnp.mean(h, axis=(1, 4))
    return {'mean': mean, 'logvar': jnp.zeros_like(mean)}


def _saved_run(path, variables, cfg):
    """A JAX ``checkpoint.msgpack`` run directory of ``variables``."""
    os.makedirs(path, exist_ok=True)
    jckpt.save_checkpoint(path, jax.device_get(dict(variables)),
                          cfg.to_dict(), 0, 0, 0.0)
    return path


def _checkpoints(root, data):
    """The UPR reference-format checkpoint of tests/test_torch_validate.py
    (9 views), and JAX-initialised INN and U-Net runs."""
    upr = os.path.join(root, 'upr')
    _checkpoint(upr, False)
    kw = dict(model_views=9, model_in_blocks=1, model_out_blocks=1,
              model_inn=True)
    jcfg = JConfig(**kw).finalize()
    z = [jnp.zeros((1, 9, 16, 16, 3))] * 4
    # jitted: flax's eager init takes ~10x longer on the CPU
    inn = _saved_run(os.path.join(root, 'inn'), jax.jit(
        JINN.from_config(jcfg).init)(jax.random.PRNGKey(3), *z), jcfg)
    kw = dict(model_chs=4, model_in_blocks=1, model_out_blocks=2,
              model_uncert=True, model_unet=True)
    jcfg = JConfig(**kw).finalize()
    unet = _saved_run(os.path.join(root, 'unet'),
                      jax.jit(JFeedForward.from_config(jcfg).init)(
                          jax.random.PRNGKey(4), *z), jcfg)
    return {'upr': upr, 'inn': inn, 'unet': unet}


@pytest.fixture(scope='module')
def runs(tmp_path_factory):
    """Every case: the JAX oracle's outputs here, and one run of the two
    ranks for all of them.  Returns ``(want, case_dir)``."""
    case_dir = str(tmp_path_factory.mktemp('mesh_val'))
    data = os.path.join(case_dir, 'data')
    generate_dataset(data, scenes=1, size=64, seed=5)
    ckpts = _checkpoints(os.path.join(case_dir, 'ckpt'), data)
    cases, want = {}, {}

    cfg = Config(**MODEL).finalize()
    live = init_live_(FeedForward.from_config(cfg), seed=7)
    variables = torch_state_to_flax(
        {k: v.numpy() for k, v in live.state_dict().items()},
        in_blocks=cfg.model_in_blocks, out_blocks=cfg.model_out_blocks)
    weights = {f'w:{k}': v.numpy() for k, v in
               state_dict_from_jax(variables, cfg).items()}
    jmodel = JFeedForward.from_config(JConfig.from_dict(cfg.to_dict()))
    rng = np.random.default_rng(8)
    stacks = [rng.random((1, 3, 24, 28, 3), dtype=np.float32)
              for _ in range(4)]
    jmesh = make_mesh(n_data=RANKS)
    for name, (step, members, offs, tie) in ENSEMBLE_CASES.items():
        grid = (-3.5, 3.5, step)
        k = len(np.arange(*grid, dtype=np.float32))
        offsets = rng.normal(0, 0.3, k).astype(np.float32) if offs else None
        arrays = {f'stack{j}': s for j, s in enumerate(stacks)}
        arrays.update(weights)
        if offs:
            arrays['offsets'] = offsets
        np.savez(os.path.join(case_dir, f'{name}.in.npz'), **arrays)
        apply_fn = _tie_apply if tie else \
            (lambda v, *a: jmodel.apply(v, *a))
        j_in = [jnp.asarray(s) for s in stacks]
        sharded = j_ensemble_sharded(apply_fn, variables, *j_in, *grid,
                                     mesh=jmesh, need_members=members,
                                     member_offsets=offsets)
        want[name] = {'sharded': sharded, 'k': k}
        cases[name] = {'kind': 'ensemble', 'model': MODEL, 'grid': grid,
                       'members': members, 'tie': tie}

    for name, (ckpt, kw) in VALIDATE_CASES.items():
        kw = dict(kw, val_loss_margin=5, val_disp_step=VAL_DISP_STEP,
                  **({'val_recalibrate': data, 'val_cal_scenes': 1}
                     if kw.get('val_recalibrate') else {}))
        jdir, tdir = (os.path.join(case_dir, name, s)
                      for s in ('jax', 'torch'))
        shutil.copytree(ckpts[ckpt], jdir)
        shutil.copytree(ckpts[ckpt], tdir)
        want[name] = (j_run_validation(jdir, data, **kw), jdir)
        cases[name] = {'kind': 'validate', 'dir': tdir, 'data': data,
                       'kw': kw}

    with open(os.path.join(case_dir, 'cases.json'), 'w') as fh:
        json.dump(cases, fh)
    reports = mesh.launch(torch_mesh_val_ranks.run_cases, RANKS,
                          (case_dir,), device_type='cpu', timeout=TIMEOUT_S,
                          store=case_dir)
    assert reports == [len(cases)] * RANKS
    return want, case_dir, stacks, live


def _rank_out(case_dir, name, r):
    with np.load(os.path.join(case_dir, f'{name}.r{r}.npz')) as z:
        return {k: z[k] for k in z}


@pytest.mark.parametrize('case', list(ENSEMBLE_CASES))
def test_sharded_ensemble_matches_jax(runs, case):
    """Every rank's outputs are rank 0's; rank 0's equal the port's serial
    ensemble (member stacks, selection and posterior to float rounding:
    the scaled per-rank posteriors sum in another order) and JAX's sharded
    one (which tests/test_parallel.py holds to JAX's serial scan) as
    tests/test_torch_ensemble.py holds the serial port:
    members and the selected logvar 5e-4, posterior 1e-4, the selected
    mean on 99.9% of pixels (near-ties).  The tie case selects member 0
    everywhere, as the serial loop's strict ``<`` does."""
    want, case_dir, stacks, live = runs
    step, members, offs, tie = ENSEMBLE_CASES[case]
    got = _rank_out(case_dir, case, 0)
    other = _rank_out(case_dir, case, 1)
    assert sorted(got) == sorted(other)
    for k in got:
        np.testing.assert_array_equal(other[k], got[k], err_msg=k)
    k_members = want[case]['k']
    assert (k_members % RANKS == 1) == (step == 0.15)     # a padded grid
    assert ('means' in got) == members
    assert got['posterior'].shape == (1, 24, 28, k_members)

    offsets = None
    if offs:
        with np.load(os.path.join(case_dir, f'{case}.in.npz')) as z:
            offsets = z['offsets']
    model = torch_mesh_val_ranks.tie_model if tie else live.eval()
    serial = ensemble_forward(model, *map(torch.from_numpy, stacks), -3.5,
                              3.5, step, member_offsets=offsets)
    for k in got:
        np.testing.assert_allclose(got[k], serial[k].numpy(), rtol=1e-6,
                                   atol=1e-6, err_msg=k)
    if tie:
        np.testing.assert_array_equal(got['mean'], got['means'][0])
    w = {k: None if v is None else np.asarray(v)
         for k, v in want[case]['sharded'].items()}
    if members:
        for k in ('means', 'logvars'):
            np.testing.assert_allclose(got[k], w[k], atol=5e-4, err_msg=k)
    agree = np.isclose(got['mean'], w['mean'], atol=5e-4)
    assert agree.mean() >= 0.999, agree.mean()
    np.testing.assert_allclose(got['logvar'], w['logvar'], atol=5e-4)
    np.testing.assert_allclose(got['posterior'], w['posterior'], atol=1e-4)


@pytest.mark.parametrize('case', list(VALIDATE_CASES))
def test_sharded_validation_matches_jax(runs, case):
    """``run_validation`` on two ranks against the JAX package's with the
    same options: metrics rel 1e-3 (the JAX ``kld`` is off float64 by
    ~1e-4, ROADMAP Queue 3); result.pfm, gmm.npy and posterior.npy 5e-4,
    as tests/test_torch_validate.py holds the whole-scene CLI."""
    want, case_dir, _, _ = runs
    (jres, jdir) = want[case]
    with open(os.path.join(case_dir, f'{case}.json')) as fh:
        got = json.load(fh)
    for k in METRICS:
        assert np.isfinite(got[k]), k
        assert got[k] == pytest.approx(jres[k], rel=1e-3, abs=1e-6), k
    tdir = os.path.join(case_dir, case, 'torch')
    sj, st = (os.path.join(d, 'scenes', 'scene_00') for d in (jdir, tdir))
    np.testing.assert_allclose(pfm.load(os.path.join(st, 'result.pfm')),
                               pfm.load(os.path.join(sj, 'result.pfm')),
                               atol=5e-4)
    names = ['posterior.npy']
    if VALIDATE_CASES[case][1].get('val_ensamble'):
        names.append('gmm.npy')
    for name in names:
        a, b = (np.load(os.path.join(s, name)) for s in (st, sj))
        assert a.shape == b.shape, name
        np.testing.assert_allclose(a, b, atol=5e-4, err_msg=name)


def test_usage_rules_match_jax(tmp_path):
    """The three scene-scale options exclude one another and
    --mesh_ensemble needs --val_ensamble, in both CLIs (before any rank
    starts in the port)."""
    data = str(tmp_path / 'data')
    generate_dataset(data, scenes=1, size=64, seed=5)
    ckpt = str(tmp_path / 'ckpt')
    _checkpoint(ckpt, False)
    for kw, match in (({'val_tile': 16, 'mesh_space': 2}, 'exclusive'),
                      ({'mesh_space': 2, 'mesh_ensemble': 2,
                        'val_ensamble': True}, 'exclusive'),
                      ({'mesh_ensemble': 2}, 'requires --val_ensamble')):
        with pytest.raises(click.UsageError, match=match):
            j_run_validation(ckpt, data, **kw)
        with pytest.raises(click.UsageError, match=match):
            run_validation(ckpt, data, device='cpu', **kw)


def test_too_few_devices_raise_like_jax(monkeypatch):
    """More ranks than devices: the JAX package's ``make_mesh`` raises a
    ValueError (8 host devices here), and so does the port for NCCL ranks
    (one a GPU) beyond the visible GPUs; gloo ranks may share a GPU, and
    on the CPU any number runs.  A scene whose rows do not split evenly
    is a ValueError in both (JAX's sharded ``device_put``)."""
    from mmlf_tpu.parallel.mesh import spatial_sharding
    with pytest.raises(ValueError):
        make_mesh(n_data=16)
    with pytest.raises(ValueError):
        jax.device_put(np.zeros((1, 3, 63, 64, 3), np.float32),
                       spatial_sharding(make_mesh(n_data=1, n_space=2), 2))
    monkeypatch.setattr(torch.cuda, 'device_count', lambda: 1)
    with pytest.raises(ValueError, match='exceeds the 1 visible GPU'):
        mesh.check_devices(2, 'cuda', 'nccl')
    with pytest.raises(ValueError, match='exceeds the 1 visible GPU'):
        mesh.check_devices(2, 'cuda')
    mesh.check_devices(2, 'cuda', 'gloo')
    mesh.check_devices(16, 'cpu')
    with pytest.raises(ValueError, match='split evenly'):
        mesh.row_share(63, 0, 2, 4)


def test_shares():
    """The member and row shares: contiguous, covering, padded."""
    for k, n in ((70, 2), (47, 2), (70, 8), (3, 4)):
        got = [mesh.member_share(k, r, n) for r in range(n)]
        per = -(-k // n)
        assert all(p == per for _, _, p in got)
        assert [i for s, e, _ in got for i in range(s, e)] == list(range(k))
    assert mesh.row_share(64, 0, 2, 6) == (0, 32, 0, 38)
    assert mesh.row_share(64, 1, 2, 6) == (32, 64, 26, 64)
    assert mesh.row_share(512, 1, 2, 128, align=16) == (256, 512, 128, 512)
    assert mesh.row_share(512, 0, 4, 20, align=16) == (0, 128, 0, 160)
