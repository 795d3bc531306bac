"""Run one cell of the benchmark of ``mmlf_tpu_torch`` once.

    python3 benchmark/run.py --workload CELL --seed N --seconds S --trace 0|1

It needs CUDA with as many cards as the cell asks for, and exits non-zero
without printing a result otherwise.  The cell names a configuration
(``configs/<name>.json``) and a traffic mix (``traffic/<name>.json``)
listed in ``BENCHMARK.json``; the configuration names its net
(``nets/<name>.py``, see ``harness/nets.py``); the per-layer metrics are
read by ``metrics/<stem>.py`` (see ``stem``); the limits of ``correct``
are in ``limits/<cell>.json``.  The last line of standard output is the
result as one JSON object; the last lines of standard error give each
compared number beside its limit.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

BENCH_DIR = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(BENCH_DIR)
sys.path.insert(0, BENCH_DIR)
# the JAX package's top-level names, compared whole (the port's name
# begins with one of them)
FORBIDDEN = ('jax', 'jaxlib', 'flax', 'mmlf_tpu')


def forbidden_modules() -> list:
    """Loaded modules whose top-level name is one of ``FORBIDDEN``."""
    return sorted({m.split('.')[0] for m in list(sys.modules)} &
                  set(FORBIDDEN))


def load_json(*parts):
    with open(os.path.join(*parts)) as f:
        return json.load(f)


def stem(name: str) -> str:
    """A metric's name up to its first dot: what it measures, where the
    rest says which end-to-end metric it belongs to (``step_mfu.train``,
    ``train_patches_per_s.fp32``).  Metrics of one stem are worked out by
    one reader, ``metrics/<stem>.py``, or one formula."""
    return name.split('.')[0]


def resolve(workload: str):
    """``(bench, cell, config, traffic, metric readers)`` of a cell."""
    bench = load_json(ROOT, 'BENCHMARK.json')
    cells = {w['name']: w for w in bench['workloads']}
    if workload not in cells:
        raise SystemExit(f'unknown workload {workload!r}; the cells are '
                         f'{sorted(cells)}')
    cell = cells[workload]
    configs = {c['name']: c for c in bench['configs']}
    config = load_json(ROOT, configs[cell['config']]['file'])
    traffic = load_json(BENCH_DIR, 'traffic', f'{cell["traffic"]}.json')
    readers = {}
    for m in bench['per_layer']:
        if workload not in m.get('workloads', [workload]):
            continue
        path = os.path.join(BENCH_DIR, 'metrics', f'{stem(m["name"])}.py')
        spec = importlib.util.spec_from_file_location(
            f'bench_metric_{len(readers)}', path)
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        readers[m['name']] = (m, mod.read)
    return bench, cell, config, traffic, readers


def end_to_end(bench: dict, cell: dict, run) -> dict:
    """The cell's end-to-end metrics, each from the window's host clock."""
    values = {'setup_s': run.setup_s,
              'train_patches_per_s': run.units * run.config[
                  'port_config']['train_bs'] / run.window_s
              if run.traffic['kind'] == 'train' else None,
              'ese_s_per_scene': run.window_s / run.units
              if run.traffic['kind'] == 'ese' else None}
    out = {}
    for m in bench['end_to_end']:
        if cell['name'] not in m.get('workloads', [cell['name']]):
            continue
        if values.get(stem(m['name'])) is None:
            raise RuntimeError(f'{m["name"]} has no value in '
                               f'{cell["name"]}')
        out[m['name']] = {'value': values[stem(m['name'])],
                          'unit': m['unit']}
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split('\n')[0])
    ap.add_argument('--workload', required=True)
    ap.add_argument('--seed', type=int, required=True)
    ap.add_argument('--seconds', type=float, required=True)
    ap.add_argument('--trace', type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    bench, cell, config, traffic, readers = resolve(args.workload)
    import torch
    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < cell['chips']:
        print(f'{args.workload} needs {cell["chips"]} CUDA card(s); '
              f'found {torch.cuda.device_count()}', file=sys.stderr)
        return 3
    sys.path.insert(0, ROOT)
    # the program's caches at fixed paths inside the checkout
    for var, sub in (('TRITON_CACHE_DIR', 'triton'),
                     ('TORCH_EXTENSIONS_DIR', 'torch_extensions')):
        os.environ[var] = os.path.join(ROOT, 'build', sub)
    from harness import check, drive

    run = drive.run_cell(cell, config, traffic, args.seed, args.seconds,
                         bool(args.trace), 'cuda', t_start=T_START)
    found = forbidden_modules()
    if found:
        print(f'modules of the JAX package are loaded: {found}',
              file=sys.stderr)
        return 4
    return report(bench, cell, run, readers,
                  check.load_limits(BENCH_DIR, cell['name']))


def report(bench, cell, run, readers, limits) -> int:
    """Print the launches, the checks and the result line; 0 if the run
    printed a result."""
    from harness import check
    print(f'launches in the window ({run.units} units): '
          f'{json.dumps(run.launches, sort_keys=True)}')
    phases = {n: round(t1 - t0, 3) for n, t0, t1 in run.spans.records
              if n.startswith('setup.')}
    print(f'set-up {run.setup_s:.3f} s, of which {json.dumps(phases)}; '
          f'window {run.window_s:.3f} s')
    if run.traffic['kind'] == 'train':
        print(f'checked losses: program {run.program["losses"]}, '
              f'reference {run.reference["losses"]}')
    checks = {k: {'value': run.checks.get(k, float('inf')), 'limit': lim}
              for k, lim in limits.items()}
    correct = bool(run.units > 0 and run.failed == 0 and
                   check.within_limits(run.checks, limits))
    if run.traced:
        metrics = {}
        for name, (m, read) in readers.items():
            value = read(run)
            if value is not None:
                metrics[name] = {'value': value, 'unit': m['unit']}
    else:
        metrics = end_to_end(bench, cell, run)
    import torch
    device = {'platform': 'gpu' if run.device.type == 'cuda' else 'cpu',
              'kind': torch.cuda.get_device_name(run.device)
              if run.device.type == 'cuda' else 'cpu',
              'count': cell['chips'], 'memory_peak_bytes': run.memory_peak}
    result = {'correct': correct, 'attempted': run.units,
              'failed': run.failed, 'metrics': metrics, 'device': device}
    if run.traced:
        device['busy_s'] = run.trace.busy_s
        device['window_s'] = run.trace.window_s
        result['breakdown'] = {'device_ops': run.trace.device_ops(),
                               'idle_gaps': run.trace.idle_gaps()}
    result['checks'] = checks
    for name, c in checks.items():
        print(f'check {name} {c["value"]!r} limit {c["limit"]!r}',
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == '__main__':
    sys.exit(main())
