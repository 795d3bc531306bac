"""A configuration names its net: the harness takes a net module and a
configuration it has never seen, from a directory of the test's own, and
judges the program's train step by that module's forward and loss.  The
net is BASE (one output channel, masked L1, ``model_uncert`` false), and
BASE on the MPI (``--train_loss_multimodal``: the alpha-weighted L1 over
the MPI's planes), which the reference's microbatch carries only for a
net whose loss reads it.  A loss planted wrong reads not correct, and the
``ese`` traffic refuses a net without mean and logvar."""

import contextlib
import io
import json
import os

import pytest

import run
from harness import check, drive, nets

BASE = '''
import torch

from harness import reference as R
from harness import weights

USES_MPI = {uses_mpi}
ESE = False


def leaves(model):
    return weights.conv_block_leaves(R.conv_blocks(model, 1))


def forward(model, params, buffers, stacks, train, update=False,
            prec='fp32', momentum=R.BN_MOMENTUM):
    x = R.Net(model, params, buffers, prec, momentum)(*stacks, train=train,
                                                      update=update)
    return {{'mean': x[:, 0]}}


def loss(out, gt, mpi, mask):
    mean = out['mean']
    err = {err}
    return (err * mask).sum() / torch.clamp(mask.sum(), min=1.0)


def flop_per_pixel(model):
    return 1


def k3_blocks(model):
    return []
'''
L1 = 'torch.abs(mean - gt)'
ERRS = {
    'l1': L1,
    'l2': '(mean - gt) ** 2',
    'mpi_l1': '(torch.abs(mean[:, None] - mpi[..., 4]) * mpi[..., 3]).sum(1)',
}


def files_under(path):
    """``{file: mtime}`` under ``path``, bytecode caches left out."""
    return {os.path.join(d, f): os.stat(os.path.join(d, f)).st_mtime_ns
            for d, dirs, fs in os.walk(path) if '__pycache__' not in d
            for f in fs}


@pytest.fixture
def base_cell(tiny, tmp_path, monkeypatch):
    """``make(err, multimodal, cell) -> (bench, cell, config, traffic)``:
    the BASE net written to ``tmp_path`` with the loss ``err``, the
    harness's net directory pointed there, and a configuration of the
    cut ``upr_fp32.train`` (or ``.ese``) that names it."""
    monkeypatch.setattr(nets, 'NETS_DIR', str(tmp_path))

    def make(err, multimodal=False, traffic='train'):
        name = f'base_{err}'
        (tmp_path / f'{name}.py').write_text(BASE.format(
            uses_mpi=multimodal, err=ERRS[err]))
        bench, _, config, traffic_mix, _ = tiny(f'upr_fp32.{traffic}')
        config = dict(config, name=name, net=name, port_config={
            **config['port_config'], 'model_uncert': False,
            'train_loss_multimodal': multimodal})
        cell = {'name': f'{name}.{traffic}', 'config': name,
                'traffic': traffic, 'chips': 1}
        bench = dict(bench, end_to_end=bench['end_to_end'] + [{
            'name': 'train_patches_per_s.base', 'unit': 'patches/s',
            'better': 'higher', 'bound': 0.25, 'source': 'host_clock',
            'workloads': [cell['name']]}])
        return bench, cell, config, traffic_mix
    return make


@pytest.mark.parametrize('err,multimodal,correct', [
    ('l1', False, True), ('l2', False, False),
    ('mpi_l1', True, True), ('l1', True, False)])
def test_a_net_from_new_files(base_cell, err, multimodal, correct):
    before = files_under(run.BENCH_DIR)
    bench, cell, config, traffic = base_cell(err, multimodal)
    r = drive.run_cell(cell, config, traffic, 2**31 + 17, 0.0, False, 'cpu')
    assert r.net.__name__ == f'bench_net_base_{err}'
    assert set(r.ref_inputs[0]) >= {'out_net.1.2.weight'}
    assert r.ref_inputs[0]['out_net.1.2.weight'].shape[0] == 1
    # the reference's scenes hold the MPI only for a net whose loss reads it
    assert all((mpi is None) is not multimodal
               for _, _, mpi, _ in r.ref_inputs[1])
    out = io.StringIO()
    with contextlib.redirect_stdout(out), \
            contextlib.redirect_stderr(io.StringIO()):
        assert run.report(bench, cell, r, {}, check.load_limits(
            run.BENCH_DIR, 'upr_fp32.train')) == 0
    res = json.loads(out.getvalue().strip().splitlines()[-1])
    assert res['correct'] is correct, res['checks']
    assert set(res['metrics']) == {'setup_s', 'train_patches_per_s.base'}
    assert files_under(run.BENCH_DIR) == before


def test_ese_refuses_a_net_without_mean_and_logvar(base_cell):
    bench, cell, config, traffic = base_cell('l1', traffic='ese')
    with pytest.raises(ValueError, match='mean and logvar'):
        drive.run_cell(cell, config, traffic, 2**31 + 19, 0.1, False, 'cpu')


def test_unknown_net(tiny):
    _, cell, config, traffic, _ = tiny('upr_fp32.train')
    for name, error in (('no_such_net', FileNotFoundError),
                        ('../harness/check', ValueError)):
        with pytest.raises(error):
            drive.run_cell(cell, dict(config, net=name), traffic, 1, 0.0,
                           False, 'cpu')
