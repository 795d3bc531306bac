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
def test_unported_options_raise(kw, dataset, tmp_path):
    _checkpoint(str(tmp_path), True)
    with pytest.raises(NotImplementedError, match='ROADMAP'):
        run_validation(str(tmp_path), dataset, val_ensamble=True,
                       device='cpu', **kw)
