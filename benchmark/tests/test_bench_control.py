"""The control, the plain reference put in the program's place and
computed in the precision below the configuration's (TF32 for the fp32
cells, fp8 for the bf16 one), comes out not correct under each cell's
limits: at a size a CPU test holds, and (on a card) at the cell's own
size, the run ``benchmark/calibrate.py`` makes for the limits."""

import pytest
import torch

import calibrate
import run
from harness import check, drive

CELLS = ['upr_bf16_trunk.train', 'upr_fp32.ese', 'upr_fp32.train',
         'upr_fp32_trunk.train']


def judged(name, values) -> bool:
    """Whether ``values`` pass every limit of the cell."""
    return check.within_limits(values,
                               check.load_limits(run.BENCH_DIR, name))


@pytest.mark.parametrize('name', CELLS)
def test_control_fails_at_cpu_size(tiny, name):
    bench, cell, config, traffic, _ = tiny(name)
    r = drive.run_cell(cell, config, traffic, 2**31 + 11, 0.0, False, 'cpu')
    assert judged(name, r.checks)
    assert not judged(name, calibrate.readings(r, config['control'], ''))


@pytest.mark.card
@pytest.mark.parametrize('name', CELLS)
def test_control_fails_at_cell_size(name):
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA card: the cell runs at its own size')
    _, cell, config, traffic, _ = run.resolve(name)
    if traffic['kind'] == 'ese':
        traffic = dict(traffic, scenes=1)
    r = drive.run_cell(cell, config, traffic, 2**31 + 13, 0.0, False,
                       'cuda')
    assert judged(name, r.checks)
    assert not judged(name, calibrate.readings(r, config['control'], ''))
