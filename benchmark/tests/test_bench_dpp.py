"""The cell ``dpp_bf16_trunk.train``: a tiny CPU run prints the result
line and reads correct; a reference planted with hard targets
(``reg_to_class`` of gt) or with the cross-entropy taken without the ReLU
reads not correct; DPP's counts (FLOP a pixel, K3's blocks, K1's bound
with the MPI words) are frozen.

The tiny runs take the cell's trunk in float32, the reference's
precision.  In bf16 a CPU-size net reads ``loss_gap`` 3e-5 to 3e-4 over
seeds (8 to 32 samples of 32² to 80², 4 to 32 channels: no size a CPU
test holds brings it down), around the limit set from the card's
full-size readings; bf16 is held on the card."""

import contextlib
import io
import json
import os
import shutil
import types

import pytest

import run
from harness import check, drive, nets, peaks

from dpp_plants import PLANTS, planted
from test_bench_cpu_run import run_tiny

DPP = 'dpp_bf16_trunk.train'


@pytest.fixture
def tiny_fp32(tiny):
    """``tiny``, with the cut cell's trunk and scene cache in float32."""
    def cut(name):
        bench, cell, config, traffic, readers = tiny(name)
        pc = dict(config['port_config'], bf16=False, cache_bf16=False)
        return bench, cell, dict(config, port_config=pc), traffic, readers
    return cut


def published():
    return run.resolve(DPP)[2]['port_config']


def test_tiny_dpp_run_is_correct(tiny_fp32):
    res = run_tiny(tiny_fp32, DPP)
    assert res['correct'] is True, res['checks']
    assert res['attempted'] > 0 and res['failed'] == 0
    assert set(res['metrics']) == {'train_patches_per_s', 'setup_s'}
    assert all(m['value'] > 0 for m in res['metrics'].values())


@pytest.mark.parametrize('plant', sorted(PLANTS))
def test_planted_reference_is_not_correct(tiny_fp32, tmp_path,
                                          monkeypatch, plant):
    src = open(os.path.join(nets.NETS_DIR, 'dpp.py')).read()
    shutil.copy(os.path.join(nets.NETS_DIR, 'upr.py'), tmp_path)
    (tmp_path / 'dpp.py').write_text(planted(src, plant))
    bench, cell, config, traffic, readers = tiny_fp32(DPP)
    r = drive.run_cell(cell, config, traffic, 2**31 + 7, 0.0, False, 'cpu')
    monkeypatch.setattr(nets, 'NETS_DIR', str(tmp_path))
    sd0, scenes, batches = r.ref_inputs
    r.reference = check.train_reference_run(config, sd0, scenes, batches,
                                            r.device)
    r.checks = check.compare_train(r.program, r.reference, sd0)
    out = io.StringIO()
    with contextlib.redirect_stdout(out), \
            contextlib.redirect_stderr(io.StringIO()):
        assert run.report(bench, cell, r, readers,
                          check.load_limits(run.BENCH_DIR, DPP)) == 0
    res = json.loads(out.getvalue().strip().splitlines()[-1])
    assert res['correct'] is False, res['checks']


def test_frozen_counts():
    net = nets.load({'net': 'dpp'})
    pc = published()
    assert net.USES_MPI and not net.ESE
    assert net.flop_per_pixel(pc) == 9_960_512
    assert net.k3_blocks(pc)[-1] == ((280, 108), 1)
    assert net.k3_blocks(pc) == [((27, 70), 4), ((70, 70), 8),
                                 ((280, 280), 7), ((280, 108), 1)]
    # K3's least time a step of the recipe at the bf16 peak (UPR's is
    # 164.98 ms: the head block's 280->108 against 280->2)
    bound = peaks.k3_step_bound_ms(net.k3_blocks(pc), 64, 96, 8,
                                   peaks.PEAK_BF16, 2)
    assert bound == pytest.approx(168.6323, rel=1e-6)


def test_k1_bound_counts_the_mpi_words():
    """K1's bound in the DPP cell: 64 windows of 128² with 128 bf16 image
    channels, 8 aux and 64 MPI words a pixel, read and written once."""
    ms, n_bytes = peaks.window_gather_bound(64, 128, 128, True, 2)
    assert n_bytes == 2 * 64 * 128 * 128 * (2 * 128 + 4 * (8 + 64)) == \
        1_140_850_688
    assert ms == pytest.approx(0.340552, rel=1e-5)
    _, cell, config, _, readers = run.resolve(DPP)
    trace = types.SimpleNamespace(kernel_s=lambda names: 8 * ms * 2e-3)
    fake = types.SimpleNamespace(trace=trace, net=nets.load(config),
                                 config=config,
                                 launches={'window_gather_bf16': 8})
    assert readers['k1_roofline.train'][1](fake) == pytest.approx(50.0)
