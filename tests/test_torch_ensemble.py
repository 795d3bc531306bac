"""The port's shift ensemble against mmlf_tpu's ensemble_forward (the
'scan' posterior) at small width, on the default 70-member grid."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from mmlf_tpu.config import Config as JConfig
from mmlf_tpu.models import FeedForward as JFeedForward
from mmlf_tpu.models.ensemble import ensemble_forward as j_ensemble_forward
from mmlf_tpu_torch.config import Config
from mmlf_tpu_torch.models.ensemble import ensemble_forward, ensemble_grid
from mmlf_tpu_torch.models.feed_forward import FeedForward, init_live_
from mmlf_tpu.utils.convert import torch_state_to_flax
from mmlf_tpu_torch.utils.convert import state_dict_from_jax

import torch_threads  # noqa: F401  torch's share of the CPUs under xdist

SMALL = dict(model_chs=6, model_views=3, model_in_blocks=1,
             model_out_blocks=2, model_uncert=True)
GRID = (-3.5, 3.5, 0.1)


def test_grid_is_float32_arange():
    g = ensemble_grid(*GRID)
    assert g.dtype == np.float32 and len(g) == 70
    np.testing.assert_array_equal(
        g, np.arange(-3.5, 3.5, 0.1, dtype=np.float32))
    assert 0 < abs(g[35]) < 1e-5          # the "zero" member is not 0.0


@pytest.mark.parametrize('offsets', [False, True])
def test_ensemble_matches_jax_scan(offsets):
    cfg = Config(**SMALL).finalize()
    live = init_live_(FeedForward.from_config(cfg), seed=7)
    variables = torch_state_to_flax(
        {k: v.numpy() for k, v in live.state_dict().items()},
        in_blocks=cfg.model_in_blocks, out_blocks=cfg.model_out_blocks)
    model = FeedForward.from_config(cfg)
    model.load_state_dict(state_dict_from_jax(variables, cfg), strict=True)
    model.eval()
    jmodel = JFeedForward.from_config(JConfig.from_dict(cfg.to_dict()))

    rng = np.random.default_rng(8)
    stacks = [rng.random((1, 3, 32, 36, 3), dtype=np.float32)
              for _ in range(4)]
    member_offsets = (rng.normal(0, 0.3, 70).astype(np.float32)
                      if offsets else None)

    got = ensemble_forward(model, *[torch.from_numpy(s) for s in stacks],
                           *GRID, member_offsets=member_offsets)
    want = j_ensemble_forward(
        lambda v, *a: jmodel.apply(v, *a), variables,
        *[jnp.asarray(s) for s in stacks], *GRID, posterior_impl='scan',
        member_offsets=member_offsets)
    want = {k: np.asarray(v) for k, v in want.items()}

    assert got['means'].shape == (70, 1, 32, 36)
    assert got['posterior'].shape == (1, 32, 36, 70)
    for key in ('means', 'logvars'):
        np.testing.assert_allclose(got[key].numpy(), want[key], atol=5e-4,
                                   err_msg=key)
    # near-ties between members may flip under reordered float sums:
    # compare the selection by agreement share, not bitwise
    agree = np.isclose(got['mean'].numpy(), want['mean'], atol=5e-4)
    assert agree.mean() >= 0.999, agree.mean()
    np.testing.assert_allclose(got['logvar'].numpy(), want['logvar'],
                               atol=5e-4)
    np.testing.assert_allclose(got['posterior'].numpy(), want['posterior'],
                               atol=1e-4)
    # the members differ: selection is not trivially member 0
    assert len(np.unique(want['logvars'].argmin(0))) > 5
