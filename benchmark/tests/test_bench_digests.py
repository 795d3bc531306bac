"""UPR's seeded weights and its reference at a size a CPU test holds, bit
for bit as the harness gave them before a configuration could name its
net (``nets/``): the initial state dict, the reference's checked steps or
ESE members, and the readings of the control and of the half fault
against it.  Digests of torch's CPU kernels on one thread (a thread count
changes the order of a conv's sums)."""

import hashlib

import pytest
import torch

import calibrate
from harness import drive

DIGESTS = {
    'upr_fp32.train': {'weights': '3feef23eb0e0936b',
                       'reference': '1f1e3f0adc1d4d9b',
                       'control': '488ca42d09e93669',
                       'half': '9d44279734965c80'},
    'upr_bf16_trunk.train': {'weights': '3feef23eb0e0936b',
                             'reference': '0174b16457c0c5d7',
                             'control': 'db2f4fa46beb689a',
                             'half': '2e14440bbd5a67e0'},
    'upr_fp32.ese': {'weights': 'fb2e5b4dfe651830',
                     'reference': 'dd5cfc1c2b69b0be',
                     'control': 'bff58ac954d433c0',
                     'half': '4f052270eba73361'},
}


def digest(tree) -> str:
    """The first 16 hex digits of a sha256 over a nest of dicts, lists,
    tensors (dtype, shape, bytes) and numbers (repr), keys sorted."""
    h = hashlib.sha256()

    def walk(prefix, x):
        if isinstance(x, dict):
            for k in sorted(x):
                walk(f'{prefix}/{k}', x[k])
        elif isinstance(x, (list, tuple)):
            for i, v in enumerate(x):
                walk(f'{prefix}/{i}', v)
        elif isinstance(x, torch.Tensor):
            t = x.detach().cpu().contiguous()
            h.update(f'{prefix}:{t.dtype}:{tuple(t.shape)}'.encode())
            h.update(t.reshape(-1).view(torch.uint8).numpy().tobytes())
        else:
            h.update(f'{prefix}={x!r}'.encode())
    walk('', tree)
    return h.hexdigest()[:16]


@pytest.fixture
def one_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        yield
    finally:
        torch.set_num_threads(threads)


@pytest.mark.parametrize('name', sorted(DIGESTS))
def test_upr_weights_and_reference_bit_for_bit(tiny, one_thread, name):
    _, cell, config, traffic, _ = tiny(name)
    r = drive.run_cell(cell, config, traffic, 2**31 + 5, 0.0, False, 'cpu')
    got = {'weights': digest(r.ref_inputs[0]),
           'reference': digest(r.reference),
           'control': digest(calibrate.readings(r, config['control'], '')),
           'half': digest(calibrate.readings(r, '', 'half'))}
    assert got == DIGESTS[name]
