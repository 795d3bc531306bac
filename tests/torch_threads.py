"""A fair share of the CPUs for torch in each pytest-xdist worker.

torch sizes its intra-op thread pool to every CPU of the process, so under
``-n 6`` on 8 CPUs six workers put some 48 busy threads on 8 cores, and
the port's CPU tests took ~4× as long as the same work with one thread a
worker.  Every ``tests/test_torch_*.py`` imports this module.  Imported in
an xdist worker (``PYTEST_XDIST_WORKER_COUNT`` set), it gives torch
``max(2, cpus // workers)`` threads.  Outside xdist (one file run alone,
or ``tests/test_torch_cuda.py`` on the card) it changes nothing.

The floor of 2: at one thread the port's fp32 train-mode U-Net flips one
ReLU derivative on ``test_unet_module_grads_match_jax``'s inputs (ROADMAP
Queue F, ``test_unet_module_grads_do_not_depend_on_threads``), and two
threads a worker ran the port's tests as fast as one.

The gloo ranks that ``parallel/mesh.launch`` spawns take their threads
from ``OMP_NUM_THREADS``, which ``mesh._rank_main`` divides over the
ranks.  It is set (unless set already) to the share times the two ranks
every rank test starts, so each rank keeps the floor: at one thread a rank
and two in the worker, ``test_mesh_data_cli_trains_on_two_ranks``'s step-1
mse leaves its 1e-3 (ROADMAP Queue F).  The rank helpers therefore do not
import this module: in a rank it would set the share before the division.

xdist collects every test file in every worker, so the share holds for
the whole worker process: the JAX package's tests that run in the same
worker see torch at the share too (XLA's own CPU pool is not touched).
"""

import os

import torch

RANKS = 2       # the gloo ranks each rank test of the port starts

WORKERS = int(os.environ.get('PYTEST_XDIST_WORKER_COUNT', '0'))
if WORKERS:
    THREADS = max(2, len(os.sched_getaffinity(0)) // WORKERS)
    torch.set_num_threads(THREADS)
    os.environ.setdefault('OMP_NUM_THREADS', str(RANKS * THREADS))
