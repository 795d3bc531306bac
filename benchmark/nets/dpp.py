"""DPP, the paper's discrete posterior head (arXiv:2203.16542, the
reference's ``--model_discrete``; head at ``mmlf/model/feed_forward.py``
276-290): the four-stream net whose last out_net block gives one logit a
disparity bin, ``steps = 4·views·3`` (108 at 9 views), trained with
``--train_loss_multimodal`` on ``MaskedCrossEntropy`` (``mmlf/model/
loss.py`` 137-149): the softmax cross-entropy of the ReLU'd logits against
the MPI's alpha-weighted multi-hot over the bins (``mpi_to_weights``).
The contract of a net module is in ``harness/nets.py``.

Departures from the reference code, none of which changes a value the
loss or its gradients take:

* the cross-entropy is written in log space, ``logsumexp(r) − Σ r·t``
  with ``r = relu(s)``, where the reference writes ``−log(exp(Σ r·t) /
  Σ exp(r))``: the same number without overflow of ``exp``;
* the soft targets are summed plane by plane; the reference's
  ``mpi_to_weights`` holds a ``(K, H, W, S)`` array first;
* the forward gives only ``scores``: the head's argmax mean, one-hot,
  softmax posterior and posterior-variance logvar, which the reference
  also computes in train mode, enter neither the loss nor its gradients;
* the bins and their catchment are the reference's: centres
  ``linspace(DISP_MIN, DISP_MAX, S)`` in float32, a plane counting in a
  bin where ``|centre − d| < step/2`` with ``step = (max − min)/S`` (not
  ``S − 1``, a quirk kept: thin gaps between the bins), alpha its weight.
"""

import numpy as np
import torch

from harness import nets
from harness import reference as R
from harness import weights

USES_MPI = True
ESE = False
# the bins' range: the reference's val_disp_min / val_disp_max defaults
DISP_MIN, DISP_MAX = -3.5, 3.5

# the trunk's count and blocks are UPR's up to the head block
UPR = nets.load({'net': 'upr'})


def steps(model: dict) -> int:
    """Bins, the last block's channels: 4 streams × views × 3."""
    if model.get('model_cross'):
        raise ValueError('the benchmark draws four-stream nets only')
    return 4 * model['model_views'] * 3


def leaves(model: dict):
    return weights.conv_block_leaves(R.conv_blocks(model, steps(model)))


def forward(model: dict, params: dict, buffers: dict, stacks, train: bool,
            update: bool = False, prec: str = 'fp32',
            momentum: float = R.BN_MOMENTUM) -> dict:
    x = R.Net(model, params, buffers, prec, momentum)(*stacks, train=train,
                                                      update=update)
    return {'scores': x.permute(0, 2, 3, 1)}


def soft_targets(mpi, n_bins: int):
    """``(b, H, W, n_bins)``: each MPI plane's alpha in the bin whose
    float32 centre lies within half a step of the plane's disparity."""
    centres = torch.from_numpy(np.linspace(DISP_MIN, DISP_MAX, n_bins)
                               .astype(np.float32)).to(mpi.device)
    half = np.float32((DISP_MAX - DISP_MIN) / n_bins / 2.0)
    out = torch.zeros(mpi.shape[:1] + mpi.shape[2:4] + (n_bins,),
                      dtype=torch.float32, device=mpi.device)
    for k in range(mpi.shape[1]):
        plane = mpi[:, k]
        hot = torch.abs(centres - plane[..., 4, None]) < float(half)
        out += hot.float() * plane[..., 3, None]
    return out


def loss(out: dict, gt, mpi, mask):
    """Softmax cross-entropy of the ReLU'd logits against the MPI's soft
    targets, averaged over the mask."""
    r = torch.relu(out['scores'])
    t = soft_targets(mpi, r.shape[-1])
    ce = torch.logsumexp(r, -1) - (r * t).sum(-1)
    return (ce * mask).sum() / torch.clamp(mask.sum(), min=1.0)


def flop_per_pixel(model: dict) -> int:
    """UPR's count of the net without its head block (9,625,280 at the
    published widths), plus the head block's two convs, 4·chs→S and S→S
    (S = 108: 241,920 + 93,312): 9,960,512."""
    cat, s = 4 * model['model_chs'], steps(model)
    return UPR.flop_per_pixel(model) + 2 * 4 * cat * s + 2 * 4 * s * s


def k3_blocks(model: dict):
    """UPR's blocks with the last one to S channels: ``((280, 108), 1)`` at
    the published widths."""
    cat = 4 * model['model_chs']
    return UPR.k3_blocks(model)[:-1] + [((cat, steps(model)), 1)]
