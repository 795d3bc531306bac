"""Every cell of BENCHMARK.json resolves by name to its configuration,
traffic, metric and limit files, and the file keeps to the contract's
shape."""

import json
import os
import re

import pytest

import run

NAME = re.compile(r'^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$')
UNIT = re.compile(r'^[A-Za-z0-9_/%.-]{1,16}$')
BENCH = json.load(open(os.path.join(run.ROOT, 'BENCHMARK.json')))
CELLS = [w['name'] for w in BENCH['workloads']]


def test_top_level_keys():
    assert set(BENCH) == {'command', 'paths', 'run_seconds', 'configs',
                          'workloads', 'end_to_end', 'per_layer'}
    assert BENCH['command'] == ['python3', 'benchmark/run.py']
    assert BENCH['paths'] == ['benchmark']
    assert 1 <= BENCH['run_seconds'] <= 51
    assert len(json.dumps(BENCH)) < 64 * 1024


@pytest.mark.parametrize('cell', CELLS)
def test_cell_resolves(cell):
    bench, entry, config, traffic, readers = run.resolve(cell)
    assert entry['chips'] == 1
    assert config['name'] == entry['config']
    assert traffic['kind'] in ('train', 'ese')
    want = {m['name'] for m in bench['per_layer']
            if cell in m.get('workloads', [cell])}
    assert set(readers) == want and want
    for name, (_, read) in readers.items():
        assert callable(read), name
    limits = json.load(open(os.path.join(run.BENCH_DIR, 'limits',
                                         f'{cell}.json')))['limits']
    assert limits and all(v > 0 for v in limits.values())


@pytest.mark.parametrize('cell', CELLS)
def test_cell_reports_its_metrics(cell):
    e2e = [m['name'] for m in BENCH['end_to_end']
           if cell in m.get('workloads', [cell])]
    assert 'setup_s' in e2e and len(e2e) >= 2
    moved = {m['moves'] for m in BENCH['per_layer']
             if cell in m.get('workloads', [cell])}
    assert moved <= set(e2e)


def test_names_units_and_files():
    names = [c['name'] for c in BENCH['configs']] + CELLS + \
        [m['name'] for m in BENCH['end_to_end'] + BENCH['per_layer']]
    assert len(names) == len(set(names))
    for n in names:
        assert NAME.match(n), n
    for m in BENCH['end_to_end'] + BENCH['per_layer']:
        assert UNIT.match(m['unit']) and m['better'] in ('lower', 'higher')
    for m in BENCH['end_to_end']:
        assert 0.01 <= m['bound'] <= 0.25
        assert m['source'] in ('host_clock', 'device_trace')
    for c in BENCH['configs']:
        path = os.path.join(run.ROOT, c['file'])
        assert c['file'].startswith('benchmark/') and os.path.exists(path)
        assert json.load(open(path))['reduced'] == c['reduced']
    used = {w['config'] for w in BENCH['workloads']}
    assert used == {c['name'] for c in BENCH['configs']}
    pairs = [(w['config'], w['traffic']) for w in BENCH['workloads']]
    assert len(pairs) == len(set(pairs))
