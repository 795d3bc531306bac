"""What the ranks of tests/test_torch_parallel.py run: one train step of
the port on the rank's part of a global batch.  Imported by the rank
processes, so it imports only torch, numpy and the port (no JAX)."""

import json
import os

import numpy as np
import torch

from mmlf_tpu_torch.config import Config
from mmlf_tpu_torch.data.hci4d import HCI4D
from mmlf_tpu_torch.data.pipeline import DevicePipeline
from mmlf_tpu_torch.models.feed_forward import FeedForward
from mmlf_tpu_torch.parallel import mesh
from mmlf_tpu_torch.train import loop


def step_cases(case_dir: str) -> int:
    """For every case of ``case_dir/cases.json`` (config keywords, data
    root, pipeline seed): load the weights of ``<name>.npz``, draw the
    global batch, take this rank's part and run one ``train_step`` (SGD at
    LR 0); rank 0 writes the loss, the gradients and the buffers to
    ``<name>.out.npz``.  Returns the number of cases."""
    with open(os.path.join(case_dir, 'cases.json')) as fh:
        cases = json.load(fh)
    for name, case in cases.items():
        cfg = Config(**case['kw']).finalize()
        pipe = DevicePipeline(HCI4D(case['root'], cache=True), cfg,
                              seed=case['seed'], device='cpu')
        model = FeedForward.from_config(cfg)
        with np.load(os.path.join(case_dir, f'{name}.npz')) as z:
            model.load_state_dict({k: torch.from_numpy(z[k]) for k in z},
                                  strict=True)
        batch = mesh.shard_batch(pipe.sample_batch(cfg.train_bs), mesh.rank(),
                                 mesh.world(), max(1, cfg.train_accum))
        optimizer = torch.optim.SGD(model.parameters(), lr=0.0)
        loss = loop.train_step(cfg, model, optimizer, pipe.cache, batch, 0)
        if mesh.rank() == 0:
            out = {f'grad/{k}': p.grad.numpy()
                   for k, p in model.named_parameters()}
            out.update({f'buffer/{k}': b.numpy()
                        for k, b in model.named_buffers()})
            np.savez(os.path.join(case_dir, f'{name}.out.npz'),
                     loss=np.float32(loss), **out)
    return len(cases)


def train_cases(case_dir: str) -> int:
    """For every case of ``case_dir/train_cases.json`` (config keywords
    and an output directory): ``train()`` in this rank's group from the
    state of ``<name>.npz``.  Returns the number of cases."""
    with open(os.path.join(case_dir, 'train_cases.json')) as fh:
        cases = json.load(fh)
    for name, case in cases.items():
        with np.load(os.path.join(case_dir, f'{name}.npz')) as z:
            state = {k: torch.from_numpy(z[k]) for k in z}
        loop.train(Config(**case['kw']).finalize(), case['out'],
                   progress=False, device='cpu', initial_state=state)
    return len(cases)
