"""The port's tiled inference (``mmlf_tpu_torch/validate/tiling.py``,
``--val_tile``) against mmlf_tpu's on the same inputs and weights: the
helpers exactly, the tiled forward of a UPR net and of the shift ensemble,
and ``run_validation(..., val_tile=64)`` end to end."""

import json
import os

import click
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from mmlf_tpu.config import Config as JConfig
from mmlf_tpu.data.synth import generate_dataset
from mmlf_tpu.models import FeedForward as JFeedForward
from mmlf_tpu.models.ensemble import ensemble_forward as j_ensemble_forward
from mmlf_tpu.utils import pfm
from mmlf_tpu.utils.convert import (save_reference_checkpoint,
                                    torch_state_to_flax)
from mmlf_tpu.validate import tiling as jT
from mmlf_tpu.validate.cli import run_validation as j_run_validation
from mmlf_tpu_torch.config import Config
from mmlf_tpu_torch.models.ensemble import ensemble_forward
from mmlf_tpu_torch.models.feed_forward import FeedForward, init_live_
from mmlf_tpu_torch.utils.convert import state_dict_from_jax
from mmlf_tpu_torch.validate import tiling as T
from mmlf_tpu_torch.validate.cli import run_validation

import torch_threads  # noqa: F401  torch's share of the CPUs under xdist

METRICS = ('mse', 'badpix', 'kld', 'kld_mm', 'kld_um', 'nll')


def _nets(chs, in_blocks, out_blocks, seed=7):
    """The port's UPR net with live random weights (eval mode) and the same
    weights as the JAX package's variables."""
    cfg = Config(model_chs=chs, model_views=9, model_in_blocks=in_blocks,
                 model_out_blocks=out_blocks, model_uncert=True).finalize()
    live = init_live_(FeedForward.from_config(cfg), seed=seed)
    variables = torch_state_to_flax(
        {k: v.numpy() for k, v in live.state_dict().items()},
        in_blocks=in_blocks, out_blocks=out_blocks)
    model = FeedForward.from_config(cfg)
    model.load_state_dict(state_dict_from_jax(variables, cfg), strict=True)
    jmodel = JFeedForward.from_config(JConfig.from_dict(cfg.to_dict()))
    return model.eval(), jmodel, variables


def _stacks(h, w, seed):
    rng = np.random.default_rng(seed)
    return [rng.random((1, 9, h, w, 3), dtype=np.float32) for _ in range(4)]


@pytest.mark.parametrize('args', [(2, 3, 8), (2, 1, 1), (3, 2, 4)])
def test_receptive_radius_matches_jax(args):
    assert T.receptive_radius(*args) == jT.receptive_radius(*args)


@pytest.mark.parametrize('h,w,tile,halo', [(512, 512, 256, 27),
                                           (128, 128, 64, 11),
                                           (72, 88, 32, 6),
                                           (90, 110, 32, 6)])
def test_tile_positions_match_jax(h, w, tile, halo):
    got = T.tile_positions(h, w, tile, halo)
    want = jT.tile_positions(h, w, tile, halo)
    assert got.dtype == want.dtype
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize('shape,win', [((1, 110, 110), 110),
                                       ((70, 1, 110, 110), 110),
                                       ((1, 110, 110, 7), 110),
                                       ((3,), 110), ((1, 108, 108), 110),
                                       ((2, 38, 38, 38), 38)])
def test_spatial_dims_match_jax(shape, win):
    """The port's single-probe ``spatial_dims`` against the JAX package's
    ``_spatial_dims`` without its second probe: heads, member-major
    stacks, bins-last posteriors, outputs with no spatial extent."""
    assert T.spatial_dims(shape, win) == jT._spatial_dims(shape, win)


@pytest.mark.parametrize('net,size', [((6, 1, 2), (96, 96)),
                                      ((4, 1, 1), (72, 88)),
                                      ((8, 1, 2), (90, 110))])
def test_tiled_forward_matches_jax_and_whole(net, size):
    """A UPR net tile by tile against the JAX package's device-side tiled
    forward and against the port's own whole-scene forward: tiling with
    the receptive radius as halo is exact, also on scenes that are not a
    tile multiple."""
    model, jmodel, variables = _nets(*net)
    stacks = _stacks(*size, seed=sum(size))
    halo = T.receptive_radius(2, net[1], net[2])
    tile = 32

    got = T.tiled_forward(model, [torch.from_numpy(s) for s in stacks],
                          tile, halo)
    whole = model(*[torch.from_numpy(s) for s in stacks])
    apply_fn = lambda v, *s: jmodel.apply(v, *s)
    want = jax.jit(lambda v, *s: jT.tiled_forward_device(
        apply_fn, v, s, tile, halo))(variables,
                                     *[jnp.asarray(s) for s in stacks])

    for k in ('mean', 'logvar', 'posterior'):
        assert got[k].shape == whole[k].shape
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]),
                                   atol=1e-5, err_msg=k)
        np.testing.assert_allclose(got[k].numpy(), whole[k].detach().numpy(),
                                   atol=1e-5, err_msg=k)
    assert got['scores'] is None and want['scores'] is None


def test_tiled_ensemble_matches_jax():
    """The shift ensemble tile by tile (the member stacks stitched on
    their own spatial dims) against the JAX package's, and against the
    port's whole-scene ensemble, on the interior: the circular shift wraps
    at the tile window's edge instead of the image border."""
    model, jmodel, variables = _nets(4, 1, 1, seed=3)
    stacks = _stacks(96, 96, seed=3)
    grid = (-0.3, 0.3, 0.2)
    halo = T.receptive_radius(2, 1, 1) + 2       # + the shift's reach

    t_stacks = [torch.from_numpy(s) for s in stacks]
    got = T.tiled_forward(lambda *w: ensemble_forward(model, *w, *grid),
                          t_stacks, 32, halo)
    whole = ensemble_forward(model, *t_stacks, *grid)
    ens = lambda v, *s: j_ensemble_forward(
        lambda vv, *a: jmodel.apply(vv, *a), v, *s, disp_min=grid[0],
        disp_max=grid[1], disp_step=grid[2])
    want = jax.jit(lambda v, *s: jT.tiled_forward_device(
        ens, v, s, 32, halo))(variables, *[jnp.asarray(s) for s in stacks])

    assert got['means'].shape == np.asarray(want['means']).shape
    assert got['posterior'].shape == np.asarray(want['posterior']).shape
    sl = (slice(None), slice(None), slice(8, -8), slice(8, -8))
    for ref in (np.asarray(want['means']), whole['means'].numpy()):
        np.testing.assert_allclose(got['means'].numpy()[sl], ref[sl],
                                   atol=1e-4)
    for ref in (np.asarray(want['mean']), whole['mean'].numpy()):
        np.testing.assert_allclose(got['mean'].numpy()[:, 8:-8, 8:-8],
                                   ref[:, 8:-8, 8:-8], atol=1e-4)


@pytest.fixture(scope='module')
def datasets(tmp_path_factory):
    root = tmp_path_factory.mktemp('torch_tiling_data')
    val, cal = str(root / 'val'), str(root / 'cal')
    generate_dataset(val, scenes=1, size=128, seed=5)
    generate_dataset(cal, scenes=1, size=128, seed=9)
    return val, cal


def _checkpoint(path, stored_ensemble):
    cfg = Config(model_chs=8, model_views=9, model_in_blocks=1,
                 model_out_blocks=2, model_uncert=True,
                 val_ensamble=stored_ensemble).finalize()
    live = init_live_(FeedForward.from_config(cfg), seed=11)
    variables = torch_state_to_flax(
        {k: v.numpy() for k, v in live.state_dict().items()},
        in_blocks=cfg.model_in_blocks, out_blocks=cfg.model_out_blocks)
    os.makedirs(path, exist_ok=True)
    save_reference_checkpoint(os.path.join(path, 'checkpoint.pt'),
                              variables, JConfig.from_dict(cfg.to_dict()))


# (stored config trained with --val_ensamble?, CLI --val_ensamble?,
#  --val_recalibrate?)
CASES = {'upr': (False, False, False), 'ese': (True, True, False),
         'ese_recalibrate': (True, True, True)}


@pytest.mark.parametrize('case', list(CASES))
def test_validate_tiled_matches_jax(case, datasets, tmp_path):
    """``run_validation(..., val_tile=64)`` on a 128² scene (4 tiles) with
    the same reference-format checkpoint in both packages: every metric,
    the ESE calibration report, the fitted member offsets and the
    artifacts, at the tolerances of tests/test_torch_validate.py."""
    stored, ens, recal = CASES[case]
    val, cal = datasets
    jdir, tdir = str(tmp_path / 'jax'), str(tmp_path / 'torch')
    for d in (jdir, tdir):
        _checkpoint(d, stored)
    kw = dict(val_loss_margin=15, val_ensamble=ens, val_disp_step=0.5,
              val_tile=64)
    if recal:
        kw.update(val_recalibrate=cal, val_cal_scenes=1)
    want = j_run_validation(
        jdir, val, val_save_calibration=os.path.join(jdir, 'cal.json')
        if recal else '', **kw)
    got = run_validation(
        tdir, val, val_save_calibration=os.path.join(tdir, 'cal.json')
        if recal else '', device='cpu', **kw)

    for k in METRICS:
        assert np.isfinite(got[k]), k
        assert got[k] == pytest.approx(want[k], rel=1e-3, abs=1e-6), k
    if ens:
        for k in ('rank_corr', 'bare_mse', 'ese_mse'):
            assert got['ese_calibration'][k] == pytest.approx(
                want['ese_calibration'][k], rel=1e-3), k
    if recal:
        offs = [np.asarray(json.load(open(os.path.join(d, 'cal.json')))
                           ['member_offsets']) for d in (tdir, jdir)]
        assert offs[0].shape == (14,) and np.any(offs[0] != 0)
        np.testing.assert_allclose(offs[0], offs[1], rtol=1e-3, atol=1e-4)

    sj = os.path.join(jdir, 'scenes', 'scene_00')
    st = os.path.join(tdir, 'scenes', 'scene_00')
    assert sorted(os.listdir(sj)) == sorted(os.listdir(st))
    np.testing.assert_allclose(pfm.load(os.path.join(st, 'result.pfm')),
                               pfm.load(os.path.join(sj, 'result.pfm')),
                               atol=5e-4)
    for name in ['posterior.npy'] + (['gmm.npy'] if ens else []):
        a = np.load(os.path.join(st, name))
        b = np.load(os.path.join(sj, name))
        assert a.shape == b.shape, name
        assert a.shape[-2:] == (128, 128), name
        np.testing.assert_allclose(a, b, atol=5e-4, err_msg=name)


@pytest.mark.parametrize('kw', [{'val_tile': 64, 'mesh_space': 2},
                                {'val_tile': 64, 'mesh_ensemble': 2},
                                {'mesh_space': 2, 'mesh_ensemble': 2}])
def test_scene_scale_options_are_mutually_exclusive(kw, tmp_path):
    """As in the JAX package, and before any option that is not ported
    raises."""
    with pytest.raises(click.UsageError, match='mutually exclusive'):
        run_validation(str(tmp_path), str(tmp_path), val_ensamble=True,
                       device='cpu', **kw)
