"""The comparison that decides ``correct``: the program's outputs against
the plain reference (``reference.py``), each number beside its limit.

Train cells: the loss of each checked step (the worst, and the first
step's), the first gradient by leaf (the norm Adam got, from its first
moment), the parameters' change and the BatchNorm running statistics'
change after the checked steps by leaf (the worst leaf, and the median
leaf, which is steady from seed to seed where rounding makes single
leaves swing).  Each leaf's gap is the gap between the two norms over the
reference's norm of that leaf or of the median leaf, whichever is
larger.  Leaves
whose reference gradient is under a thousandth of the median leaf's (the
biases of convs that a BatchNorm follows: nought but round-off, which Adam
scales up to full steps) are left out of the gradient and of the
change.

ESE cells: the members' means and logvars, the selection (how far the
member the program chose lies above the reference's least logvar at each
pixel), the mixture posterior (each pixel's L1 gap over the reference's
mass or the median pixel's, whichever is larger, averaged over the
pixels) and the reported metrics (relative gap; computed, not compared:
see PERF.md).
"""

from __future__ import annotations

import json
import os

import numpy as np
import torch

from . import nets, synth
from . import reference as R

# leaves whose reference gradient is under this share of the median leaf's
# are left out of the gradient and the change (Adam moves them by
# round-off)
ZERO_GRAD_SHARE = 1e-3


def load_limits(bench_dir: str, cell: str) -> dict:
    with open(os.path.join(bench_dir, 'limits', f'{cell}.json')) as f:
        return json.load(f)['limits']


# ------------------------------------------------------------------ train

def train_reference_run(config: dict, sd0: dict, scenes, batches,
                        device, prec: str = '', fault: str = '') -> dict:
    """The reference's checked steps on the program's drawn batches, in
    the configuration's precision unless ``prec`` names another."""
    pc = config['port_config']
    prec = prec or config['reference']
    net = nets.load(config)
    ref_scenes = R.TrainScenes(scenes, float(pc['train_shift']),
                               bool(pc.get('cache_bf16')), net.USES_MPI)
    out = R.train_reference(net, pc, pc, sd0, ref_scenes, batches, device,
                            prec, fault)
    out['state'] = {**out['params'], **out['buffers']}
    return out


def within_limits(values: dict, limits: dict) -> bool:
    """Whether every compared number is at or under its limit (a number
    missing from ``values`` fails)."""
    return all(values.get(k, float('inf')) <= lim
               for k, lim in limits.items())


def _leaf_gaps(prog: dict, ref: dict, keys) -> dict:
    """Each leaf's ``|‖prog‖ - ‖ref‖| / max(‖ref‖, median ‖ref‖)``."""
    keys = list(keys)
    if not keys:
        return {'': 0.0}
    pn = {k: float(torch.linalg.vector_norm(
        prog[k].to(ref[k].device).double())) for k in keys}
    rn = {k: float(torch.linalg.vector_norm(ref[k].double())) for k in keys}
    med = float(np.median(list(rn.values())))
    return {k: abs(pn[k] - rn[k]) / max(rn[k], med, 1e-30) for k in keys}


def _train_leaf_gaps(program: dict, ref: dict, sd0: dict):
    """``(grads, changes, stats)``: each compared leaf's gap of the first
    gradient, of the parameters' change and of the running statistics'
    change after the checked steps."""
    params = list(ref['grads'])
    rn = {k: float(torch.linalg.vector_norm(ref['grads'][k].double()))
          for k in params}
    med = float(np.median(list(rn.values())))
    moved = [k for k in params if rn[k] >= ZERO_GRAD_SHARE * med]

    def change(state, keys):
        return {k: state[k].to(sd0[k].device).float() - sd0[k].float()
                for k in keys}

    stats = [k for k in ref['state'] if k.endswith(('running_mean',
                                                    'running_var'))]
    return (_leaf_gaps(program['grads'], ref['grads'], moved),
            _leaf_gaps(change(program['state'], moved),
                       change(ref['state'], moved), moved),
            _leaf_gaps(change(program['state'], stats),
                       change(ref['state'], stats), stats))


def worst_leaves(program: dict, ref: dict, sd0: dict, top: int = 3):
    """The compared leaves with the largest gradient and change gaps, for
    a look at what a reading comes from: ``{number: [[leaf, gap], ...]}``."""
    grads, changes, _ = _train_leaf_gaps(program, ref, sd0)
    return {name: sorted(([k, v] for k, v in gaps.items()),
                         key=lambda kv: -kv[1])[:top]
            for name, gaps in (('grad', grads), ('change', changes))}


def compare_train(program: dict, ref: dict, sd0: dict) -> dict:
    """``{number: value}`` of a train cell.  ``program`` and ``ref`` hold
    ``losses``, ``grads`` (first step, by parameter) and ``state`` (after
    the checked steps, parameters and running statistics)."""
    losses = [abs(p - r) / max(abs(r), 1e-30)
              for p, r in zip(program['losses'], ref['losses'])]
    if len(program['losses']) != len(ref['losses']) or \
            not all(np.isfinite(program['losses'])):
        losses.append(float('inf'))
    grads, changes, stats = (list(g.values()) for g in
                             _train_leaf_gaps(program, ref, sd0))
    return {'loss_gap': max(losses),
            'loss0_gap': losses[0],
            'grad_gap': max(grads),
            'grad_median_gap': float(np.median(grads)),
            'change_gap': max(changes),
            'change_median_gap': float(np.median(changes)),
            'bn_stats_gap': max(stats)}


# -------------------------------------------------------------------- ese

def shifted_stacks(views: dict, shift: float):
    """A scene's four stacks in [0, 1], EPI-shifted by ``shift``."""
    stacks = synth.stacks_of(views)
    return R.shift_stacks(*stacks, shift) if shift else stacks


@torch.no_grad()
def calibrate_bn(config: dict, sd: dict, stacks, device) -> None:
    """Give ``sd`` the running statistics of one train-mode forward of the
    configuration's net on ``stacks`` (in place), so an eval checkpoint's
    activations neither vanish nor explode through the blocks."""
    R.no_tf32()
    params, buffers = R.split_state(sd, device)
    nets.load(config).forward(config['port_config'], params, buffers,
                              [R.fold(s)[None] for s in stacks], train=True,
                              update=True, momentum=1.0)
    for k, v in buffers.items():
        sd[k].copy_(v)


def ese_reference_run(config: dict, sd: dict, stacks, gt, mpi,
                      traffic: dict, device, prec: str = '',
                      fault: str = '') -> dict:
    """The reference's members, selection, posterior and metrics of one
    scene (stacks already shifted by ``train_shift``; gt and the MPI's
    disparities are corrected here), in the configuration's precision
    unless ``prec`` names another."""
    prec = prec or config['reference']
    shift = np.float32(traffic['train_shift'])
    lo, hi = float(traffic['disp_min']), float(traffic['disp_max'])
    grid = R.ensemble_grid(lo, hi, float(traffic['disp_step']))
    if fault == 'half':
        grid = grid[::2]
    means, logvars = R.ese_members(nets.load(config), config['port_config'],
                                   sd, stacks, grid, device, prec, fault)
    mpi = mpi.clone()
    mpi[..., 4] -= shift
    best_lv, best = torch.min(logvars, 0)
    selected = torch.gather(means, 0, best[None])[0]
    return {'means': means, 'logvars': logvars, 'selected': selected,
            'posterior': R.mixture_posterior(means, logvars, lo, hi,
                                             len(grid)),
            'metrics': R.scene_metrics(selected, best_lv, gt.to(device),
                                       mpi.to(device), lo, hi)}


def as_program(ref: dict) -> dict:
    """A reference run's outputs in the program's artifact layout (the
    control and the planted faults take the program's place)."""
    best = torch.min(ref['logvars'], 0).values
    return {'gmm': torch.stack([ref['means'], torch.exp(ref['logvars'])]
                               ).cpu().numpy(),
            'posterior': ref['posterior'].permute(2, 0, 1).cpu().numpy(),
            'result': ref['selected'].cpu().numpy(),
            'uncert_scale': torch.exp(best).cpu().numpy(),
            'metrics': ref['metrics']}


def compare_ese(program: dict, ref: dict) -> dict:
    """``{number: value}`` of an ESE cell."""
    dev = ref['means'].device
    means = torch.from_numpy(np.ascontiguousarray(program['gmm'][0])).to(dev)
    lvs = torch.log(torch.from_numpy(
        np.ascontiguousarray(program['gmm'][1])).to(dev))
    result = torch.from_numpy(np.ascontiguousarray(program['result'])).to(dev)
    inf = float('inf')
    if means.shape != ref['means'].shape:
        return dict.fromkeys(('member_mean_gap', 'member_logvar_gap',
                              'selection_gap', 'posterior_gap',
                              'metric_gap'), inf)
    # the member the program chose: the first whose mean and scale are its
    # result's (two members can share a float32 mean by chance)
    uncert = torch.from_numpy(np.ascontiguousarray(
        program['uncert_scale'])).to(dev)
    hit = (means == result[None]) & (
        torch.from_numpy(np.ascontiguousarray(program['gmm'][1])).to(dev)
        == uncert[None])
    chosen = torch.argmax(hit.to(torch.uint8), 0)
    above = torch.gather(ref['logvars'], 0, chosen[None])[0] - \
        ref['logvars'].min(0).values
    selection = float(above.max()) if bool(hit.any(0).all()) else inf
    post = torch.from_numpy(np.ascontiguousarray(program['posterior'])).to(
        dev).permute(1, 2, 0)
    if post.shape != ref['posterior'].shape:
        post_gap = inf
    else:
        # each pixel's L1 gap over its mass or the median pixel's,
        # whichever is larger, averaged over the pixels: a member's mean
        # off by one rounding moves a sharp Laplace law (scale exp(logvar)
        # far below a bin) by that rounding over its scale, so a widest
        # pixel swings by orders of magnitude from seed to seed
        mass = ref['posterior'].double().sum(-1)
        mass = torch.clamp(mass, min=float(mass.median()))
        post_gap = float(((post.double() - ref['posterior'].double()).abs()
                          .sum(-1) / mass).mean())
    reported = program['metrics']
    if reported is None:
        metric_gap = inf
    else:
        metric_gap = max(abs(reported[k] - v) / max(abs(v), 1e-30)
                         for k, v in ref['metrics'].items())
    return {'member_mean_gap': float((means - ref['means']).abs().max()),
            'member_logvar_gap': float((lvs - ref['logvars']).abs().max()),
            'selection_gap': selection,
            'posterior_gap': post_gap,
            'metric_gap': metric_gap}
