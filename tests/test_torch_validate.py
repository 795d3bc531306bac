"""The port's validate CLI against mmlf_tpu's on the same synthetic scene
and the same reference-format checkpoint: every metric and the artifacts
(result.pfm, posterior.npy, gmm.npy)."""

import os

import numpy as np
import pytest

from mmlf_tpu.config import Config as JConfig
from mmlf_tpu.data.synth import generate_dataset
from mmlf_tpu.utils import pfm
from mmlf_tpu.utils.convert import (save_reference_checkpoint,
                                    torch_state_to_flax)
from mmlf_tpu.validate.cli import run_validation as j_run_validation
from mmlf_tpu_torch.config import Config
from mmlf_tpu_torch.models.feed_forward import FeedForward, init_live_
from mmlf_tpu_torch.validate.cli import run_validation

import torch_threads  # noqa: F401  torch's share of the CPUs under xdist

SMALL = dict(model_chs=8, model_views=9, model_in_blocks=1,
             model_out_blocks=2, model_uncert=True)
METRICS = ('mse', 'badpix', 'kld', 'kld_mm', 'kld_um', 'nll')

# (stored config trained with --val_ensamble?, CLI --val_ensamble?)
CASES = {'upr': (False, False), 'upr_ese': (False, True),
         'ese': (True, True)}


@pytest.fixture(scope='module')
def dataset(tmp_path_factory):
    root = str(tmp_path_factory.mktemp('torch_validate_data'))
    generate_dataset(root, scenes=1, size=64, seed=5)
    return root


def _checkpoint(path, stored_ensemble):
    cfg = Config(**SMALL, val_ensamble=stored_ensemble).finalize()
    live = init_live_(FeedForward.from_config(cfg), seed=11)
    variables = torch_state_to_flax(
        {k: v.numpy() for k, v in live.state_dict().items()},
        in_blocks=cfg.model_in_blocks, out_blocks=cfg.model_out_blocks)
    os.makedirs(path, exist_ok=True)
    save_reference_checkpoint(os.path.join(path, 'checkpoint.pt'),
                              variables, JConfig.from_dict(cfg.to_dict()))


@pytest.mark.parametrize('case', list(CASES))
def test_validate_matches_jax(case, dataset, tmp_path):
    stored, ens = CASES[case]
    jdir, tdir = str(tmp_path / 'jax'), str(tmp_path / 'torch')
    for d in (jdir, tdir):
        _checkpoint(d, stored)

    kw = dict(val_loss_margin=15, val_ensamble=ens)
    want = j_run_validation(jdir, dataset, **kw)
    got = run_validation(tdir, dataset, device='cpu', **kw)

    for k in METRICS:
        assert np.isfinite(got[k]), k
        assert got[k] == pytest.approx(want[k], rel=1e-3, abs=1e-6), k
    if ens:
        for k in ('rank_corr', 'bare_mse', 'ese_mse'):
            assert got['ese_calibration'][k] == pytest.approx(
                want['ese_calibration'][k], rel=1e-3), k

    sj = os.path.join(jdir, 'scenes', 'scene_00')
    st = os.path.join(tdir, 'scenes', 'scene_00')
    assert sorted(os.listdir(sj)) == sorted(os.listdir(st))
    np.testing.assert_allclose(pfm.load(os.path.join(st, 'result.pfm')),
                               pfm.load(os.path.join(sj, 'result.pfm')),
                               atol=5e-4)
    names = ['posterior.npy'] + (['gmm.npy'] if ens else [])
    for name in names:
        a = np.load(os.path.join(st, name))
        b = np.load(os.path.join(sj, name))
        assert a.shape == b.shape, name
        np.testing.assert_allclose(a, b, atol=5e-4, err_msg=name)
    post = np.load(os.path.join(st, 'posterior.npy'))
    assert post.shape[0] == (70 if ens else 108)   # bins first on disk
    assert os.path.exists(os.path.join(tdir, 'ours', 'runtimes',
                                       'scene_00.txt'))


@pytest.mark.parametrize('kw', [{'mesh_space': 2}, {'mesh_ensemble': 2}])
def test_mesh_options_validate_like_jax(kw, dataset, tmp_path):
    """--mesh_space and --mesh_ensemble: the library entry starts two gloo
    ranks itself and its ESE metrics and artifacts agree with the JAX
    package's with the same option (rel 1e-3, 5e-4;
    tests/test_torch_mesh_val.py runs the other cases); its report lists
    each rank's launch counts."""
    jdir, tdir = str(tmp_path / 'jax'), str(tmp_path / 'torch')
    for d in (jdir, tdir):
        _checkpoint(d, True)
    kw = dict(kw, val_ensamble=True, val_disp_step=0.5)    # 14 members
    want = j_run_validation(jdir, dataset, **kw)
    got = run_validation(tdir, dataset, device='cpu', **kw)
    assert [r['rank'] for r in got['ranks']] == [0, 1]
    for k in METRICS:
        assert got[k] == pytest.approx(want[k], rel=1e-3, abs=1e-6), k
    for name in ('gmm.npy', 'posterior.npy'):
        np.testing.assert_allclose(
            *(np.load(os.path.join(d, 'scenes', 'scene_00', name))
              for d in (tdir, jdir)), atol=5e-4, err_msg=name)


def test_model_invertible_is_ignored_like_jax(dataset, tmp_path):
    """Both validate CLIs accept --model_invertible and ignore it: on one
    checkpoint each gives with the flag what it gives without (result.pfm
    and posterior.npy bit for bit), and the two agree (5e-4)."""
    from click.testing import CliRunner
    from mmlf_tpu.validate.cli import main as j_main
    from mmlf_tpu_torch.validate.cli import main
    out = {}
    for pkg, cli, extra in (('jax', j_main, []),
                            ('torch', main, ['--device', 'cpu'])):
        for flag in ([], ['--model_invertible']):
            d = str(tmp_path / f'{pkg}{len(flag)}')
            _checkpoint(d, False)
            res = CliRunner().invoke(cli, [d, dataset, '--val_loss_margin',
                                           '15'] + flag + extra)
            assert res.exit_code == 0, res.output
            out[pkg, len(flag)] = [
                np.asarray(pfm.load(os.path.join(d, 'scenes', 'scene_00',
                                                 'result.pfm'))),
                np.load(os.path.join(d, 'scenes', 'scene_00',
                                     'posterior.npy'))]
    for pkg in ('jax', 'torch'):
        for a, b in zip(out[pkg, 0], out[pkg, 1]):
            np.testing.assert_array_equal(a, b)
    for a, b in zip(out['torch', 1], out['jax', 1]):
        np.testing.assert_allclose(a, b, atol=5e-4)
