"""Kernel K2 (Laplace-mixture posterior): the port's plain version against
the Pallas kernel in interpret mode, at the shapes and tolerance of
tests/test_pallas.py.  The CUDA kernel itself is held against the plain
version in tests/test_torch_cuda.py, on a card."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from mmlf_tpu.ops.pallas import posterior as jP
from mmlf_tpu_torch.ops.kernels import posterior as tP


def _inputs(rng, k, p, kb):
    means = rng.uniform(-3, 3, (k, p)).astype(np.float32)
    scales = rng.uniform(0.2, 2.0, (k, p)).astype(np.float32)
    bins = np.linspace(-3.5, 3.5, kb).astype(np.float32)
    return means, scales, bins


@pytest.mark.parametrize('case', [
    ('mixture', 7, 300, 11),      # p deliberately not a tile multiple
    ('mixture', 70, 257, 70),     # the ESE member/bin count
    ('ensemble', 5, (1, 6, 8)),
    ('ensemble', 70, (1, 9, 7)),
])
def test_plain_posterior_matches_pallas(case):
    rng = np.random.default_rng(len(str(case)))
    if case[0] == 'mixture':
        _, k, p, kb = case
        means, scales, bins = _inputs(rng, k, p, kb)
        got = tP.laplace_mixture_posterior(
            torch.from_numpy(means), torch.from_numpy(scales),
            torch.from_numpy(bins)).numpy()
        want = np.asarray(jP.laplace_mixture_posterior(
            jnp.asarray(means), jnp.asarray(scales), jnp.asarray(bins),
            interpret=True))
        assert got.shape == (p, kb)
        np.testing.assert_allclose(got, want.T, rtol=2e-5, atol=1e-6)
    else:
        _, k, spatial = case
        means = rng.uniform(-2, 2, (k,) + spatial).astype(np.float32)
        logvars = rng.uniform(-1, 0.5, (k,) + spatial).astype(np.float32)
        got = tP.ensemble_posterior(torch.from_numpy(means),
                                    torch.from_numpy(logvars),
                                    -3.5, 3.5).numpy()
        want = np.asarray(jP.ensemble_posterior(
            jnp.asarray(means), jnp.asarray(logvars), -3.5, 3.5,
            interpret=True))
        assert got.shape == spatial + (k,)
        np.testing.assert_allclose(got, want, rtol=2e-5, atol=1e-6)
