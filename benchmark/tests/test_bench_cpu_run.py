"""A tiny run on the CPU prints the contract's last line, and the run
command refuses to run without a card."""

import contextlib
import io
import json
import os
import subprocess
import sys

import pytest

import run
from harness import check, drive

CELLS = ['upr_bf16_trunk.train', 'upr_fp32.ese', 'upr_fp32.train',
         'upr_fp32_trunk.train']


def run_tiny(tiny, name, traced=False, seed=2**31 + 7, patch=None):
    """One run of a cut cell on the CPU; returns the result line."""
    bench, cell, config, traffic, readers = tiny(name)
    r = drive.run_cell(cell, config, traffic, seed, 0.5, traced, 'cpu')
    out, err = io.StringIO(), io.StringIO()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        assert run.report(bench, cell, r, readers,
                          check.load_limits(run.BENCH_DIR, name)) == 0
    lines = err.getvalue().strip().splitlines()
    assert all(line.startswith('check ') for line in lines[-len(r.checks):])
    return json.loads(out.getvalue().strip().splitlines()[-1])


@pytest.mark.parametrize('name', CELLS)
def test_tiny_run_prints_the_result_line(tiny, name):
    res = run_tiny(tiny, name)
    assert set(res) == {'correct', 'attempted', 'failed', 'metrics',
                        'device', 'checks'}
    assert list(res)[-1] == 'checks'
    assert res['correct'] is True and res['attempted'] > 0
    assert res['failed'] == 0
    e2e = {m['name'] for m in run.resolve(name)[0]['end_to_end']
           if name in m.get('workloads', [name])}
    assert set(res['metrics']) == e2e
    assert all(m['value'] > 0 for m in res['metrics'].values())
    assert set(res['device']) == {'platform', 'kind', 'count',
                                  'memory_peak_bytes'}


def test_traced_tiny_run(tiny):
    res = run_tiny(tiny, 'upr_fp32.ese', traced=True)
    assert {'busy_s', 'window_s'} <= set(res['device'])
    assert set(res['breakdown']) == {'device_ops', 'idle_gaps'}
    assert res['metrics']['host_s.ese']['value'] > 0


def test_no_card_no_result(tmp_path):
    import torch
    if torch.cuda.is_available():
        pytest.skip('a card is present')
    proc = subprocess.run(
        [sys.executable, os.path.join(run.BENCH_DIR, 'run.py'),
         '--workload', 'upr_fp32.train', '--seed', '1', '--seconds', '1',
         '--trace', '0'], capture_output=True, text=True, cwd=tmp_path,
        timeout=120)
    assert proc.returncode != 0 and proc.stdout.strip() == ''
