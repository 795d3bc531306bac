"""Shared set-up of the benchmark's own tests: the harness and the port on
the path, and ``tiny``, a cell cut to a size a CPU test can hold."""

import os
import sys

import pytest

BENCH_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
ROOT = os.path.dirname(BENCH_DIR)
for p in (ROOT, BENCH_DIR):
    if p not in sys.path:
        sys.path.insert(0, p)

TINY_MODEL = dict(model_chs=4, model_in_blocks=1, model_out_blocks=2,
                  train_bs=8, train_accum=2, train_ps=32,
                  train_max_downscale=1)
TINY_TRAFFIC = dict(scenes=2, scene_size=64)


def pytest_configure(config):
    config.addinivalue_line('markers',
                            'card: needs a CUDA card (skips without one)')


@pytest.fixture
def tiny():
    """``tiny(cell_name) -> (bench, cell, config, traffic, readers)`` with
    the configuration and the traffic cut to CPU size."""
    import run

    def cut(name):
        bench, cell, config, traffic, readers = run.resolve(name)
        config = dict(config, port_config={**config['port_config'],
                                           **TINY_MODEL})
        traffic = {**traffic, **TINY_TRAFFIC}
        return bench, cell, config, traffic, readers
    return cut
