"""UPR, the paper's uncertainty head (arXiv:2203.16542, the reference's
``--model_uncert``): the four-stream net whose last out_net block gives
two channels, the mean and the logvar, trained on the heteroscedastic L1
loss.  The contract of a net module is in ``harness/nets.py``."""

import torch

from harness import reference as R
from harness import weights

USES_MPI = False
ESE = True


def leaves(model: dict):
    return weights.conv_block_leaves(R.conv_blocks(model, 2))


def forward(model: dict, params: dict, buffers: dict, stacks, train: bool,
            update: bool = False, prec: str = 'fp32',
            momentum: float = R.BN_MOMENTUM) -> dict:
    x = R.Net(model, params, buffers, prec, momentum)(*stacks, train=train,
                                                      update=update)
    return {'mean': x[:, 0], 'logvar': x[:, 1]}


def loss(out: dict, gt, mpi, mask):
    """Heteroscedastic L1, ``exp(-logvar)·|mean - gt| + logvar``, averaged
    over the mask."""
    mean, logvar = out['mean'], out['logvar']
    loss = torch.exp(-logvar) * torch.abs(mean - gt) + logvar
    count = mask.sum()
    return (loss * mask).sum() / torch.clamp(count, min=1.0)


def flop_per_pixel(model: dict) -> int:
    """Forward FLOP per output pixel of the four-stream net with k=2
    convs: 4 streams of one (3·views)→chs and 2·in_blocks − 1 chs→chs
    convs, then out_blocks − 1 out_net blocks of two 4·chs→4·chs convs
    (the 4·chs→2 head is left out).  9,625,280 at the published widths
    (``chip_smoke.conv_flop_per_pixel``, frozen)."""
    chs, views = model['model_chs'], model['model_views']
    in_blocks, out_blocks = model['model_in_blocks'], \
        model['model_out_blocks']
    cat = 4 * chs
    return 4 * (2 * 4 * 3 * views * chs
                + (2 * in_blocks - 1) * 2 * 4 * chs * chs) + \
        (out_blocks - 1) * 2 * 2 * 4 * cat * cat


def k3_blocks(model: dict):
    """``[((cin, cout), count)]`` of the k=2 conv blocks of one forward:
    the four streams' blocks and the out_net's, the last one to 2
    channels (``chip_smoke.K3_BLOCKS``, frozen)."""
    chs, views = model['model_chs'], model['model_views']
    cat = 4 * chs
    return [((3 * views, chs), 4), ((chs, chs), 4 * (model['model_in_blocks']
                                                     - 1)),
            ((cat, cat), model['model_out_blocks'] - 1), ((cat, 2), 1)]
