"""Tests of the port that need a CUDA card (they skip without one).

The CUDA kernels have no CPU mode, so each is held here against its plain
PyTorch version on the card.  This file imports neither JAX nor mmlf_tpu,
so it also runs where JAX is not installed:

    python -m pytest --noconftest tests/test_torch_cuda.py
"""

import numpy as np
import pytest
import torch

from mmlf_tpu_torch.config import Config
from mmlf_tpu_torch.models.ensemble import ensemble_forward
from mmlf_tpu_torch.models.feed_forward import FeedForward, init_live_
from mmlf_tpu_torch.ops.kernels import posterior as K

# the kernel's exponential is ex2.approx on a pre-scaled argument (a few
# ulp), against expf and a division in the plain version
TOL = dict(rtol=1e-4, atol=1e-6)


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA card: the kernels have no CPU mode')
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device('cuda')


def _inputs(dev, k, p, kb, seed=0):
    rng = np.random.default_rng(seed)
    means = rng.uniform(-3, 3, (k, p)).astype(np.float32)
    scales = rng.uniform(0.05, 2.0, (k, p)).astype(np.float32)
    bins = np.linspace(-3.5, 3.5, kb).astype(np.float32)
    return [torch.from_numpy(a).to(dev) for a in (means, scales, bins)]


@pytest.mark.parametrize('k,p,kb', [(70, 512 * 512, 70), (7, 300, 11),
                                    (3, 33, 200), (1, 1, 1), (33, 100, 256)])
def test_mixture_kernel_matches_plain(cuda, k, p, kb):
    means, scales, bins = _inputs(cuda, k, p, kb, seed=k + p + kb)
    before = K.laplace_mixture_posterior.launches
    got = K.laplace_mixture_posterior(means, scales, bins)
    torch.cuda.synchronize()
    assert K.laplace_mixture_posterior.launches == before + 1
    assert got.shape == (p, kb)
    torch.testing.assert_close(
        got, K.plain_mixture_posterior(means, scales, bins), **TOL)


def test_mixture_kernel_rejects_too_many_bins(cuda):
    means, scales, bins = _inputs(cuda, 2, 8, K.max_bins() + 1)
    with pytest.raises(ValueError, match='bins'):
        K.laplace_mixture_posterior(means, scales, bins)


def test_ensemble_on_card_matches_cpu(cuda):
    cfg = Config(model_chs=8, model_views=9, model_in_blocks=1,
                 model_out_blocks=2, model_uncert=True).finalize()
    model = init_live_(FeedForward.from_config(cfg), seed=3).eval()
    rng = np.random.default_rng(4)
    stacks = [torch.from_numpy(rng.random((1, 9, 40, 48, 3),
                                          dtype=np.float32))
              for _ in range(4)]
    want = ensemble_forward(model, *stacks, -3.5, 3.5, 0.1)
    before = K.laplace_mixture_posterior.launches
    got = ensemble_forward(model.to(cuda), *[s.to(cuda) for s in stacks],
                           -3.5, 3.5, 0.1)
    torch.cuda.synchronize()
    assert K.laplace_mixture_posterior.launches == before + 1
    for key in ('means', 'logvars'):
        torch.testing.assert_close(got[key].cpu(), want[key], rtol=0,
                                   atol=5e-4)
    agree = (got['mean'].cpu() - want['mean']).abs() < 5e-4
    assert agree.float().mean() >= 0.999
    torch.testing.assert_close(got['posterior'].cpu(), want['posterior'],
                               rtol=1e-3, atol=1e-4)
