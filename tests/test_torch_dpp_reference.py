"""The port's DPP train microbatch (``--model_discrete
--train_loss_multimodal``) against the benchmark's plain reference of the
net, ``benchmark/nets/dpp.py``, loaded by path: on seeded lecun-normal
weights at a small size in float32, the soft targets, the loss and every
leaf's gradient.  The comparison fails when the reference is planted with
hard targets (``reg_to_class`` of gt) or with the ReLU left out of the
cross-entropy, so it is tight enough to see either."""

import importlib.util
import os
import sys

import numpy as np
import pytest
import torch

from mmlf_tpu_torch.config import Config
from mmlf_tpu_torch.models import build_model
from mmlf_tpu_torch.ops.codecs import mpi_to_weights
from mmlf_tpu_torch.train import loop

import torch_threads  # noqa: F401  torch's share of the CPUs under xdist

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BENCH_DIR = os.path.join(ROOT, 'benchmark')
DPP_PATH = os.path.join(BENCH_DIR, 'nets', 'dpp.py')
PLANTS_PATH = os.path.join(BENCH_DIR, 'tests', 'dpp_plants.py')
MODEL = dict(model_ksize=2, model_chs=8, model_in_blocks=1,
             model_out_blocks=2, model_views=9, model_uncert=False,
             model_discrete=True, train_loss_multimodal=True)
B, PS, PLANES = 2, 32, 12
# fp32 on both sides; the port's BatchNorm statistics and conv backward sum
# in other orders than the reference's, about 1e-6 of a value through two
# blocks (seen: the loss equal, the worst leaf 1.2e-6 to 1.6e-6): the loss
# within 1e-5 of itself, each leaf's gradient within 1e-4 of the larger of
# its norm and the median leaf's (biases before a BatchNorm have a gradient
# of round-off only, so their own norm is no scale).  Hard targets move
# the loss by 1.6e-3 and the worst leaf by half its norm, logits without
# the ReLU by 1.4e-2 and 0.68.
LOSS_RTOL = 1e-5
GRAD_RTOL = 1e-4


def load(name, path):
    """The module at ``path``."""
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


# the faults planted in the reference (``benchmark/tests/dpp_plants.py``)
plants = load('dpp_plants', PLANTS_PATH)


def load_dpp(tmp_path=None, plant=''):
    """``benchmark/nets/dpp.py`` as a module, the harness on the path; with
    ``plant``, a copy under ``tmp_path`` with that fault."""
    if BENCH_DIR not in sys.path:
        sys.path.insert(0, BENCH_DIR)
    path = DPP_PATH
    if plant:
        path = str(tmp_path / f'dpp_{plant}.py')
        with open(path, 'w') as f:
            f.write(plants.planted(open(DPP_PATH).read(), plant))
    return load(f'dpp_under_test_{plant}', path)


def make_mpi(gen):
    """A 12-plane MPI ``(B, 12, PS, PS, 5)``: planes 0-2 carry alphas that
    sum to 1 at each pixel (fractional: soft targets over up to three
    bins), disparities in range, one of them on a bin's catchment edge;
    planes 3-11 zero, as the port pads a scene's planes."""
    mpi = torch.zeros((B, PLANES, PS, PS, 5))
    alpha = torch.rand((3, B, PS, PS), generator=gen) ** 2
    alpha = alpha / alpha.sum(0)
    step = 7.0 / 108
    centre = np.float32(np.linspace(-3.5, 3.5, 108)[40])
    disp = torch.tensor([-2.3, 0.7, float(centre) + step / 2])
    for k in range(3):
        mpi[:, k, ..., :3] = torch.rand((B, PS, PS, 3), generator=gen)
        mpi[:, k, ..., 3] = alpha[k]
        mpi[:, k, ..., 4] = disp[k] + 0.2 * torch.rand((B, PS, PS),
                                                      generator=gen)
    mpi[:, 2, :, :PS // 2, 4] = disp[2]
    return mpi


def inputs(seed):
    gen = torch.Generator().manual_seed(seed)
    stacks = [torch.rand((B, 27, PS, PS), generator=gen) for _ in range(4)]
    mpi = make_mpi(gen)
    # gt: the strongest plane's disparity, as a loader's gt is the front
    strongest = torch.argmax(mpi[..., 3], 1)
    gt = torch.take_along_dim(mpi[..., 4], strongest[:, None], 1)[:, 0]
    mask = (torch.rand((B, PS, PS), generator=gen) > 0.1).to(torch.int32)
    return stacks, gt, mpi, mask


def port_step(cfg, sd, stacks, gt, mpi, mask):
    """The port's forward, targets and loss of one microbatch in train
    mode, and each parameter's gradient."""
    model = build_model(cfg)
    model.load_state_dict(sd, strict=True)
    model.train()
    out = model(*stacks, folded=True)
    gt_, mpi_, gt_classes, mask_, pad = loop.prepare_targets(cfg, gt, mpi,
                                                             mask)
    loss = loop.compute_loss(cfg, out, gt_, mpi_, gt_classes, mask_, pad,
                             step=0)
    params = dict(model.named_parameters())
    grads = torch.autograd.grad(loss, list(params.values()))
    return float(loss.detach()), dict(zip(params, grads))


def reference_step(dpp, sd, stacks, gt, mpi, mask):
    """The reference's forward and loss of the same microbatch under the
    train mask (the texture mask times the margin-11 window), and each
    parameter's gradient."""
    from harness import reference as R
    R.no_tf32()
    params, buffers = R.split_state(sd, 'cpu')
    margin = torch.zeros((PS, PS))
    margin[R.LOSS_MARGIN:PS - R.LOSS_MARGIN,
           R.LOSS_MARGIN:PS - R.LOSS_MARGIN] = 1.0
    out = dpp.forward(MODEL, params, buffers, stacks, train=True,
                      update=True)
    loss = dpp.loss(out, gt, mpi, mask.float() * margin)
    grads = torch.autograd.grad(loss, list(params.values()))
    return float(loss.detach()), dict(zip(params, grads))


def gaps(port, ref):
    """``(loss gap, worst leaf gap)``: the loss's relative gap and each
    leaf's gradient gap over the larger of its norm and the median
    leaf's."""
    (lp, gp), (lr, gr) = port, ref
    norms = {k: float(torch.linalg.vector_norm(g)) for k, g in gr.items()}
    med = float(np.median(list(norms.values())))
    leaf = max(float(torch.linalg.vector_norm(gp[k] - gr[k])) /
               max(norms[k], med) for k in gr)
    return abs(lp - lr) / abs(lr), leaf


def run_both(seed, pallas_trunk=False, dpp=None):
    dpp = dpp or load_dpp()
    from harness import weights
    cfg = Config(**MODEL, pallas_trunk=pallas_trunk).finalize()
    torch.manual_seed(seed)
    sd = weights.make_state_dict(dpp, MODEL, seed, 'cpu')
    stacks, gt, mpi, mask = inputs(seed)
    port = port_step(cfg, {k: v.clone() for k, v in sd.items()}, stacks, gt,
                     mpi, mask)
    ref = reference_step(dpp, sd, stacks, gt, mpi, mask)
    return port, ref


def test_soft_targets_equal_mpi_to_weights():
    dpp = load_dpp()
    _, _, mpi, _ = inputs(3)
    want = mpi_to_weights(mpi, -3.5, 3.5, 108)
    got = dpp.soft_targets(mpi, 108)
    assert torch.equal(got, want)
    # three planes with fractional alphas: up to three bins a pixel, and
    # the edge disparity in no bin (the catchment is half-open)
    assert int((want > 0).sum(-1).max()) == 3
    assert float(want.sum(-1).min()) < 1.0


@pytest.mark.parametrize('pallas_trunk', [False, True],
                         ids=['plain', 'trunk'])
def test_dpp_microbatch_matches_reference(pallas_trunk):
    port, ref = run_both(2**31 + 11, pallas_trunk)
    loss_gap, grad_gap = gaps(port, ref)
    assert loss_gap <= LOSS_RTOL, loss_gap
    assert grad_gap <= GRAD_RTOL, grad_gap
    # every leaf took part: the head's 108 channels and the trunk's
    assert port[1]['out_net.1.2.weight'].shape[0] == 108
    assert all(float(g.abs().max()) > 0 for k, g in port[1].items()
               if k.endswith('weight'))


@pytest.mark.parametrize('plant', sorted(plants.PLANTS))
def test_planted_fault_fails(tmp_path, plant):
    port, ref = run_both(2**31 + 11, dpp=load_dpp(tmp_path, plant))
    loss_gap, grad_gap = gaps(port, ref)
    assert loss_gap > 10 * LOSS_RTOL and grad_gap > 10 * GRAD_RTOL, \
        (loss_gap, grad_gap)

