"""The port's FeedForward against mmlf_tpu's FeedForward.apply, with the
weights carried across by state_dict_from_jax; BN folding; and the
reference-checkpoint round trip from the JAX package to the port."""

import os

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from mmlf_tpu.config import Config as JConfig
from mmlf_tpu.models import FeedForward as JFeedForward
from mmlf_tpu.utils.convert import save_reference_checkpoint
from mmlf_tpu.utils.convert import torch_state_to_flax
from mmlf_tpu.utils.fold_bn import fold_batchnorm as j_fold_batchnorm
from mmlf_tpu_torch.config import Config
from mmlf_tpu_torch.models.feed_forward import FeedForward, init_live_
from mmlf_tpu_torch.utils.convert import (load_checkpoint_pt,
                                          state_dict_from_jax)
from mmlf_tpu_torch.utils.fold_bn import fold_batchnorm

import torch_threads  # noqa: F401  torch's share of the CPUs under xdist

SMALL = dict(model_chs=8, model_views=3, model_in_blocks=2,
             model_out_blocks=3)

HEADS = {
    'base': {},
    'uncert': {'model_uncert': True},
    'discrete': {'model_discrete': True},
    'cross': {'model_uncert': True, 'model_cross': True},
    'no_batchnorm': {'model_uncert': True, 'model_no_batchnorm': True},
}


def jax_variables(cfg: Config, seed: int = 0) -> dict:
    """Live (input-sensitive) JAX variables for ``cfg``, made by the
    port's seeded initializer and converted by the JAX package."""
    model = init_live_(FeedForward.from_config(cfg), seed)
    sd = {k: v.numpy() for k, v in model.state_dict().items()}
    return torch_state_to_flax(
        sd, in_blocks=cfg.model_in_blocks, out_blocks=cfg.model_out_blocks,
        no_batchnorm=cfg.model_no_batchnorm, cross=cfg.model_cross)


def port_model(cfg: Config, variables: dict) -> FeedForward:
    model = FeedForward.from_config(cfg)
    model.load_state_dict(state_dict_from_jax(variables, cfg), strict=True)
    return model.eval()


def _stacks(rng, n, h=16, w=20):
    return [rng.random((1, n, h, w, 3), dtype=np.float32) for _ in range(4)]


@pytest.mark.parametrize('head', list(HEADS))
def test_feed_forward_matches_jax(head):
    cfg = Config(**SMALL, **HEADS[head]).finalize()
    variables = jax_variables(cfg, seed=1)
    model = port_model(cfg, variables)
    jmodel = JFeedForward.from_config(JConfig.from_dict(cfg.to_dict()))

    rng = np.random.default_rng(2)
    stacks = _stacks(rng, cfg.model_views)      # non-square: H != W
    with torch.no_grad():
        got = model(*[torch.from_numpy(s) for s in stacks])
    want = jmodel.apply(variables, *[jnp.asarray(s) for s in stacks])

    for key in ('mean', 'logvar', 'posterior', 'scores', 'one_hot'):
        if want[key] is None:
            assert got[key] is None, key
            continue
        np.testing.assert_allclose(got[key].numpy(), np.asarray(want[key]),
                                   atol=5e-4, err_msg=key)

    # guard: the comparison is meaningless if the net ignores its inputs;
    # every stream must move the output (dead-net oracle trap)
    n_streams = 2 if cfg.model_cross else 4
    for s in range(n_streams):
        z = [torch.from_numpy(x) for x in stacks]
        z[s] = torch.zeros_like(z[s])
        with torch.no_grad():
            moved = (model(*z)['mean'] - got['mean']).abs().max()
        assert float(moved) > 1e-3, f'stream {s} does not move the output'


def test_fold_batchnorm_matches_jax_and_unfolded():
    cfg = Config(**SMALL, model_uncert=True).finalize()
    variables = jax_variables(cfg, seed=3)
    sd = state_dict_from_jax(variables, cfg)
    folded = fold_batchnorm(sd)

    cfg_nb = Config.from_dict({**cfg.to_dict(), 'model_no_batchnorm': True})
    want = state_dict_from_jax(j_fold_batchnorm(variables), cfg_nb)
    assert set(folded) == set(want)
    for k in want:
        np.testing.assert_allclose(folded[k].numpy(), want[k].numpy(),
                                   rtol=1e-6, atol=1e-6, err_msg=k)

    model = port_model(cfg, variables)
    model_nb = FeedForward.from_config(cfg_nb)
    model_nb.load_state_dict(folded, strict=True)
    model_nb.eval()
    rng = np.random.default_rng(4)
    stacks = [torch.from_numpy(s) for s in _stacks(rng, cfg.model_views)]
    with torch.no_grad():
        a, b = model(*stacks), model_nb(*stacks)
    for key in ('mean', 'logvar'):
        np.testing.assert_allclose(a[key].numpy(), b[key].numpy(),
                                   atol=1e-5, err_msg=key)


def test_reference_checkpoint_roundtrip(tmp_path):
    """JAX save_reference_checkpoint → port load_checkpoint_pt: the same
    weights and stored config, and a strict load into the port model."""
    cfg = Config(**SMALL, model_uncert=True, val_ensamble=True).finalize()
    variables = jax_variables(cfg, seed=5)
    path = os.path.join(tmp_path, 'checkpoint.pt')
    save_reference_checkpoint(path, variables,
                              JConfig.from_dict(cfg.to_dict()))

    sd, hyper = load_checkpoint_pt(path)
    assert hyper == cfg.to_dict()
    want = state_dict_from_jax(variables, cfg)
    assert set(sd) == set(want)
    for k in want:
        np.testing.assert_array_equal(sd[k].numpy(), want[k].numpy(),
                                      err_msg=k)
    model = FeedForward.from_config(Config.from_dict(hyper))
    model.load_state_dict(sd, strict=True)


def test_model_invertible_raises():
    """--model_invertible (the reference's INN) is refused by
    ``build_model`` and ``FeedForward.from_config``."""
    from mmlf_tpu_torch.models import build_model
    cfg = Config(**SMALL, model_invertible=True).finalize()
    with pytest.raises(NotImplementedError,
                       match='INNs are not supported anymore'):
        build_model(cfg)
    with pytest.raises(NotImplementedError,
                       match='INNs are not supported anymore'):
        FeedForward.from_config(cfg)


@pytest.mark.parametrize('flags', [('model_unet', 'model_inn'),
                                   ('model_inn',)],
                         ids=['model_unet_with_inn', 'model_inn'])
def test_build_model_makes_the_jax_inn(flags):
    """An INN config builds the INN, with --model_unet ignored as in the
    JAX package, and its weights and eval forward are the JAX INN's."""
    import jax
    from mmlf_tpu.models.inn import INN as JINN
    from mmlf_tpu_torch.models import build_model
    cfg = Config(**SMALL, **dict.fromkeys(flags, True)).finalize()
    stacks = [np.random.default_rng(j).random((1, 3, 8, 8, 3), np.float32)
              for j in range(4)]
    jm = JINN.from_config(JConfig(**SMALL, **dict.fromkeys(flags, True))
                          .finalize())
    variables = jax.jit(jm.init)(jax.random.PRNGKey(0),
                                 *map(jnp.asarray, stacks))
    model = build_model(cfg)
    assert type(model).__name__ == 'INN'
    model.load_state_dict(state_dict_from_jax(jax.device_get(dict(
        variables)), cfg), strict=True)
    want = jm.apply(variables, *map(jnp.asarray, stacks))
    with torch.no_grad():
        got = model.eval()(*map(torch.from_numpy, stacks))
    for k in ('zixels', 'jac', 'posterior'):
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]),
                                   rtol=1e-5, atol=1e-5, err_msg=k)
