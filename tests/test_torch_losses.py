"""Every ported loss of mmlf_tpu_torch.losses against mmlf_tpu.losses on the
same seeded inputs, including empty masks and an empty out-of-range set,
and their gradients against jax.grad."""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from mmlf_tpu import losses as JL
from mmlf_tpu_torch import losses as L

import torch_threads  # noqa: F401  torch's share of the CPUs under xdist

# fp32 sums over a few hundred terms, taken in another order
RTOL = 1e-5
ATOL = 1e-6


def _inputs(seed, empty_mask=False, full_planes=False):
    rng = np.random.default_rng(seed)
    b, k, h, w, s = 2, 3, 8, 10, 6
    mpi = rng.random((b, k, h, w, 5), dtype=np.float32)
    mpi[..., 4] = rng.uniform(-2, 2, (b, k, h, w)).astype(np.float32)
    alpha = rng.random((b, k, h, w), dtype=np.float32)
    if not full_planes:
        alpha[:, :, :3] = 0.0          # an out-of-range band (sum w < 0.01)
    mpi[..., 3] = alpha / k
    mask = (rng.random((b, h, w)) > 0.3).astype(np.int32)
    if empty_mask:
        mask[:] = 0
    target = rng.random((b, h, w, s), dtype=np.float32)
    return {
        'out': {'mean': rng.normal(size=(b, h, w)).astype(np.float32),
                'logvar': rng.normal(size=(b, h, w)).astype(np.float32),
                'scores': rng.normal(size=(b, h, w, s)).astype(np.float32)},
        'gt': rng.normal(size=(b, h, w)).astype(np.float32),
        'mpi': mpi, 'mask': mask,
        'padding': (rng.random((b, h, w)) > 0.5).astype(np.int32),
        'classes': target / target.sum(-1, keepdims=True),
    }


def _args(name, x, lib):
    """The call of loss ``name`` on ``x`` converted by ``lib``."""
    out, gt, mpi, mask = x['out'], x['gt'], x['mpi'], x['mask']
    pad = x['padding']
    return {
        'masked_l1': (out, gt, mask),
        'masked_mse': (out, gt, mask),
        'masked_badpix': (out, gt, mask),
        'multi_masked_l1': (out, mpi, mask),
        'masked_cross_entropy': (out, x['classes'], mask),
        'uncertainty_mse': (out, gt, mask),
        'uncertainty_l1': (out, gt, mask),
        'improved_uncertainty_l1': (out, gt, mask),
        'improved_uncertainty_l1_padding': (out, gt, mask, pad),
        'improved_uncertainty_l1_all_in_range': (out, gt, mask,
                                                 np.ones_like(pad)),
        'multi_uncertainty_l1': (out, mpi, mask),
        'improved_multi_uncertainty_l1': (out, mpi, mask),
        'logvar_anchor': (out, gt, mpi, mask),
        'logvar_anchor_padding': (out, gt, mpi, mask, pad),
        'logvar_anchor_multimodal': (out, gt, mpi, mask, None, True),
    }[name]


NAMES = ['masked_l1', 'masked_mse', 'masked_badpix', 'multi_masked_l1',
         'masked_cross_entropy', 'uncertainty_mse', 'uncertainty_l1',
         'improved_uncertainty_l1', 'improved_uncertainty_l1_padding',
         'improved_uncertainty_l1_all_in_range', 'multi_uncertainty_l1',
         'improved_multi_uncertainty_l1', 'logvar_anchor',
         'logvar_anchor_padding', 'logvar_anchor_multimodal']


def _fn(name, lib):
    for suffix in ('_padding', '_all_in_range', '_multimodal'):
        name = name.replace(suffix, '')
    return getattr(lib, name)


def _convert(args, to):
    def one(a):
        if isinstance(a, dict):
            return {k: one(v) for k, v in a.items()}
        if isinstance(a, np.ndarray):
            return to(a)
        return a
    return [one(a) for a in args]


@pytest.mark.parametrize('case', ['plain', 'empty_mask', 'empty_oor'])
@pytest.mark.parametrize('name', NAMES)
def test_loss_matches_jax(name, case):
    x = _inputs(seed=NAMES.index(name), empty_mask=case == 'empty_mask',
                full_planes=case == 'empty_oor')
    want = float(_fn(name, JL)(*_convert(_args(name, x, JL), jnp.asarray)))
    got = float(_fn(name, L)(*_convert(_args(name, x, L), torch.from_numpy)))
    assert np.isfinite(got)
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize('name', ['improved_uncertainty_l1_padding',
                                  'improved_multi_uncertainty_l1',
                                  'masked_cross_entropy',
                                  'logvar_anchor_multimodal'])
def test_loss_gradients_match_jax(name):
    """Gradients w.r.t. the head outputs (the anchor's target is
    detached in both)."""
    x = _inputs(seed=40)
    keys = ('mean', 'logvar', 'scores')

    def jloss(heads):
        args = _convert(_args(name, x, JL), jnp.asarray)
        args[0] = dict(args[0], **heads)
        return _fn(name, JL)(*args)

    jgrads = jax.grad(jloss)({k: jnp.asarray(x['out'][k]) for k in keys})
    heads = {k: torch.from_numpy(x['out'][k]).requires_grad_()
             for k in keys}
    args = _convert(_args(name, x, L), torch.from_numpy)
    args[0] = dict(args[0], **heads)
    _fn(name, L)(*args).backward()
    for k in keys:
        want = np.asarray(jgrads[k])
        got = heads[k].grad
        got = np.zeros_like(want) if got is None else got.numpy()
        np.testing.assert_allclose(got, want, rtol=1e-4,
                                   atol=1e-6 * max(1.0, np.abs(want).max()),
                                   err_msg=k)


def test_dead_losses_raise():
    """The reference's dead losses raise, as they do in the JAX
    package."""
    for fn in (L.multi_masked_mse, L.multi_uncertainty_mse):
        with pytest.raises(NotImplementedError):
            fn(None, None, None)


def test_information_bottleneck_matches_jax():
    """The INN's information bottleneck equals the JAX one (rel 1e-6) on
    random distances, log-dets and one-hot targets."""
    rng = np.random.default_rng(12)
    dists = rng.uniform(0, 50, (2, 6, 7, 36)).astype(np.float32)
    target = np.eye(36, dtype=np.float32)[rng.integers(0, 36, (2, 6, 7))]
    out = {'zixels': rng.normal(size=(2, 6, 7, 36)).astype(np.float32),
           'jac': rng.normal(size=(2,)).astype(np.float32),
           'mu': rng.normal(size=(1, 36, 36)).astype(np.float32),
           'dists': dists}
    for beta in (1.0, 0.3):
        want = JL.information_bottleneck(
            {k: jnp.asarray(v) for k, v in out.items()},
            jnp.asarray(target), beta)
        got = L.information_bottleneck(
            {k: torch.from_numpy(v) for k, v in out.items()},
            torch.from_numpy(target), beta)
        assert float(got) == pytest.approx(float(want), rel=1e-6)
