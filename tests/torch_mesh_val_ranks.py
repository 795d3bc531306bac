"""What the ranks of tests/test_torch_mesh_val.py run: the port's sharded
ensemble and its sharded validation, inside a group of ranks.  Imported by
the rank processes, so it imports only torch, numpy and the port (no
JAX)."""

import json
import os

import numpy as np
import torch

from mmlf_tpu_torch.config import Config
from mmlf_tpu_torch.models.ensemble import ensemble_forward_sharded
from mmlf_tpu_torch.models.feed_forward import FeedForward
from mmlf_tpu_torch.parallel import mesh
from mmlf_tpu_torch.validate.cli import run_validation

METRICS = ('mse', 'badpix', 'kld', 'kld_mm', 'kld_um', 'nll')


def tie_model(h, v, i, d):
    """Every member's logvar is 0: the selection is a tie everywhere."""
    mean = h.mean(dim=(1, 4))
    return {'mean': mean, 'logvar': torch.zeros_like(mean)}


def run_cases(case_dir: str) -> int:
    """Every case of ``case_dir/cases.json``: ``ensemble`` cases run
    ``ensemble_forward_sharded`` on ``<name>.in.npz`` (stacks, weights,
    offsets) and each rank writes its outputs to ``<name>.r<rank>.npz``;
    ``validate`` cases run ``run_validation`` in this group and rank 0
    writes the metrics to ``<name>.json``.  Returns the number of cases."""
    with open(os.path.join(case_dir, 'cases.json')) as fh:
        cases = json.load(fh)
    for name, case in cases.items():
        if case['kind'] == 'validate':
            res = run_validation(case['dir'], case['data'], device='cpu',
                                 **case['kw'])
            if mesh.rank() == 0:
                with open(os.path.join(case_dir, f'{name}.json'), 'w') as fh:
                    json.dump({k: res[k] for k in METRICS}, fh)
            continue
        with np.load(os.path.join(case_dir, f'{name}.in.npz')) as z:
            arrays = {k: z[k] for k in z}
        stacks = [torch.from_numpy(arrays[f'stack{j}']) for j in range(4)]
        if case['tie']:
            model = tie_model
        else:
            model = FeedForward.from_config(Config(**case['model']).finalize())
            model.load_state_dict({k[2:]: torch.from_numpy(a)
                                   for k, a in arrays.items()
                                   if k.startswith('w:')}, strict=True)
            model.eval()
        out = ensemble_forward_sharded(
            model, *stacks, *case['grid'], need_members=case['members'],
            member_offsets=arrays.get('offsets'))
        np.savez(os.path.join(case_dir, f'{name}.r{mesh.rank()}.npz'),
                 **{k: v.numpy() for k, v in out.items() if v is not None})
    return len(cases)
