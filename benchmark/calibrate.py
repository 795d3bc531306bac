"""Readings that the limits of ``correct`` are set from (not run by the
benchmark's own runs).

    python3 benchmark/calibrate.py --workload CELL --seeds 1,2,3 \\
        [--control-seeds 1,2,3] [--out FILE]

For each seed: one run of the cell with the shortest window, its compared
numbers (the program's readings); for each control seed also the readings
of the reference put in the program's place at the precision below the
configuration's (``control`` in the configuration file) and of the planted
faults the cell can have (half of each microbatch, or every other ESE
member, left out; for ESE also one member's mean altered).  One JSON line
each, to ``--out`` and to standard output.
"""

import argparse
import json
import os
import sys
import time

BENCH_DIR = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, BENCH_DIR)
sys.path.insert(0, os.path.dirname(BENCH_DIR))

import run as bench_run  # noqa: E402
from harness import check, drive  # noqa: E402

FAULTS = {'train': ('half',), 'ese': ('half', 'member')}


def readings(run, prec: str, fault: str) -> dict:
    """The compared numbers of the reference at ``prec`` with ``fault``
    in the program's place, against the run's reference."""
    dev = run.device
    if run.traffic['kind'] == 'train':
        sd0, scenes, batches = run.ref_inputs
        other = check.train_reference_run(run.config, sd0, scenes, batches,
                                          dev, prec, fault)
        return check.compare_train(other, run.reference, sd0)
    other = check.ese_reference_run(run.config, *run.ref_inputs,
                                    run.traffic, dev, prec, fault)
    return check.compare_ese(check.as_program(other), run.reference)


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument('--workload', required=True)
    ap.add_argument('--seeds', required=True)
    ap.add_argument('--control-seeds', default='')
    ap.add_argument('--scenes', type=int, default=0,
                    help='ESE: val scenes a run makes (0: the traffic\'s)')
    ap.add_argument('--out', default='')
    args = ap.parse_args()
    _, cell, config, traffic, _ = bench_run.resolve(args.workload)
    if args.scenes:
        traffic = dict(traffic, scenes=args.scenes)
    control = set(int(s) for s in args.control_seeds.split(',') if s)
    out = open(args.out, 'a') if args.out else None
    for seed in [int(s) for s in args.seeds.split(',')]:
        t = time.perf_counter()
        run = drive.run_cell(cell, config, traffic, seed, 0.0, False, 'cuda')
        rows = [('program', run.checks)]
        if traffic['kind'] == 'train':
            rows.append(('program_leaves', check.worst_leaves(
                run.program, run.reference, run.ref_inputs[0])))
        if seed in control:
            rows.append((config['control'], readings(run, config['control'],
                                                      '')))
            for fault in FAULTS[traffic['kind']]:
                rows.append((fault, readings(run, '', fault)))
        for kind, values in rows:
            line = json.dumps({'workload': args.workload, 'seed': seed,
                               'kind': kind, 'readings': values,
                               'setup_s': run.setup_s,
                               'seconds': time.perf_counter() - t})
            print(line, flush=True)
            if out:
                print(line, file=out, flush=True)
        del run
        drive._empty(drive.torch.device('cuda'))
    return 0


if __name__ == '__main__':
    sys.exit(main())
