"""The frozen counts and bounds give ``chip_smoke.py``'s numbers: the
peaks and kernel bounds of ``harness/peaks.py``, and UPR's counts in its
net module at the published widths of its configurations."""

import pytest

import chip_smoke
import run
from harness import nets, peaks

UPR = nets.load({})
PUBLISHED = run.load_json(run.BENCH_DIR, 'configs', 'upr_fp32.json')[
    'port_config']

RECIPE_MB = dict(b=64, ps=96, accum=1)


def test_peaks_are_chip_smokes():
    for name in ('PEAK_BYTES', 'PEAK_FP32', 'PEAK_TF32', 'PEAK_BF16',
                 'PEAK_3XTF32'):
        assert getattr(peaks, name) == getattr(chip_smoke, name)


def test_step_and_member_flop():
    per_pixel = UPR.flop_per_pixel(PUBLISHED)
    assert per_pixel == chip_smoke.conv_flop_per_pixel() == 9_625_280
    assert 3 * per_pixel * 96 ** 2 * 512 == pytest.approx(1.363e14,
                                                          rel=1e-3)
    assert per_pixel * 512 ** 2 == pytest.approx(2.523e12, rel=1e-3)


@pytest.mark.parametrize('img_bytes,ms', [(4, 0.3406), (2, 0.1803)])
def test_k1_bound(img_bytes, ms):
    got = peaks.window_gather_bound(64, 128, 128, False, img_bytes)
    assert got == chip_smoke.window_gather_bound(64, 128, 128, False,
                                                 img_bytes)
    assert got[0] == pytest.approx(ms, abs=5e-5)


def test_k2_bound():
    got = peaks.posterior_bound(70, 512 ** 2, 70)
    assert got == chip_smoke.posterior_bound(70, 512 ** 2, 70)
    assert got[0] == pytest.approx(0.0967, abs=5e-5)
    assert got[1] == 'operations'


@pytest.mark.parametrize('peak,eb,fwd,bwd', [
    (peaks.PEAK_BF16, 2, 5.92, 14.70), (peaks.PEAK_3XTF32, 4, 34.96, 87.32)])
def test_k3_bound_per_microbatch(peak, eb, fwd, bwd):
    f = b = 0.0
    for (cin, cout), n in UPR.k3_blocks(PUBLISHED):
        got = peaks.k3_bound(64, 96, 96, cin, cout, peak, eb)
        assert got == chip_smoke.k3_bound(64, 96, 96, cin, cout, peak, eb)
        f += n * got[0][0]
        b += n * got[1][0]
    assert f == pytest.approx(fwd, abs=5e-3)
    assert b == pytest.approx(bwd, abs=5e-3)
    assert peaks.k3_step_bound_ms(UPR.k3_blocks(PUBLISHED), 64, 96, 8,
                                  peak, eb) == \
        pytest.approx(8 * (f + b))


def test_trunk_blocks_are_chip_smokes():
    want = {(cin, cout): n for (cin, cout, _, _), n in chip_smoke.K3_BLOCKS
            if n}
    assert dict(UPR.k3_blocks(PUBLISHED)) == want


@pytest.mark.parametrize('config', ['upr_bf16_trunk', 'upr_fp32',
                                    'upr_fp32_trunk'])
def test_upr_configs_are_published_widths(config):
    pc = run.load_json(run.BENCH_DIR, 'configs', f'{config}.json')[
        'port_config']
    assert UPR.flop_per_pixel(pc) == 9_625_280
    assert UPR.k3_blocks(pc) == UPR.k3_blocks(PUBLISHED)
