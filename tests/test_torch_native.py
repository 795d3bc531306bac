"""The port's host library (``mmlf_tpu_torch/native.py`` and its own C++
source) against the JAX package's: the texture mask and the stride-f window
cutter, native against native and numpy fallback against numpy fallback,
bit for bit."""

import os

import numpy as np
import pytest

from mmlf_tpu import native as jnative
from mmlf_tpu.ops.masks import create_mask_texture as jax_mask
from mmlf_tpu_torch import native
from mmlf_tpu_torch.ops.masks import create_mask_texture

import torch_threads  # noqa: F401  torch's share of the CPUs under xdist

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope='module')
def libs():
    if jnative.get_lib() is None:
        pytest.skip('the JAX package\'s native library is unavailable')
    native.reset()
    if native.get_lib() is None:
        pytest.skip('g++ is unavailable')
    return native.get_lib()


@pytest.fixture
def numpy_only(monkeypatch):
    """Both packages with native code disabled (each by its own switch);
    the loaded libraries come back after the test."""
    monkeypatch.setenv(native.DISABLE_ENV, '1')
    monkeypatch.setenv('MMLF_TPU_NO_NATIVE', '1')
    native.reset()
    saved = jnative._LIB, jnative._TRIED
    jnative._LIB, jnative._TRIED = None, False
    yield
    monkeypatch.delenv(native.DISABLE_ENV)
    native.reset()
    jnative._LIB, jnative._TRIED = saved


def _scene(kind: str, shape, seed: int) -> np.ndarray:
    rng = np.random.default_rng(seed)
    h, w = shape
    if kind == 'random':
        return rng.random((h, w, 3), dtype=np.float32)
    if kind == 'flat':
        c = rng.random((h, w, 3), dtype=np.float32)
        c[h // 5:h // 2, w // 4:3 * w // 4] = 0.5
        c[-h // 4:, :w // 3] = 0.0
        return c
    # low texture: uniform noise of amplitude 0.04-0.06 a row on a gentle
    # ramp puts the MAD of most pixels within a few tenths of the 0.02
    # threshold, on both sides of it
    ramp = np.linspace(0.45, 0.55, w, dtype=np.float32)[None, :, None]
    amp = np.float32(0.04) + np.float32(0.02) * rng.random(
        (h, 1, 1), dtype=np.float32)
    return (ramp + amp * rng.random((h, w, 3), dtype=np.float32)).astype(
        np.float32)


CASES = [('random', (96, 80)), ('flat', (96, 80)), ('low', (64, 64)),
         ('low', (53, 71)), ('random', (31, 47)), ('flat', (15, 19)),
         ('random', (20, 30))]


@pytest.mark.parametrize('kind,shape', CASES)
def test_native_mask_equals_jax_native(libs, kind, shape):
    """The port's native mask against the JAX package's native library and
    its default ``create_mask_texture``, on random, flat, near-threshold,
    odd-sized and smaller-than-window scenes."""
    for seed in range(3):
        center = _scene(kind, shape, seed)
        got = create_mask_texture(center)
        np.testing.assert_array_equal(got, jnative.texture_mask(
            center, 23, 0.02))
        np.testing.assert_array_equal(got, jax_mask(center))
        assert got.dtype == np.int32 and got.shape == shape
        if min(shape) < 23:
            assert not got.any()


def test_low_texture_scene_is_near_the_threshold(libs):
    """The near-threshold scenes really sit at the threshold: a share of
    their pixels on each side."""
    center = _scene('low', (64, 64), 0)
    inner = create_mask_texture(center)[11:-11, 11:-11]
    assert 0.05 < inner.mean() < 0.95


@pytest.mark.parametrize('kind,shape', CASES)
def test_numpy_mask_equals_jax_numpy(numpy_only, kind, shape):
    """With native code disabled in both packages, the numpy fallbacks."""
    assert native.get_lib() is None and jnative.get_lib() is None
    for seed in range(2):
        center = _scene(kind, shape, seed)
        np.testing.assert_array_equal(create_mask_texture(center),
                                      jax_mask(center))


def test_native_and_numpy_masks_agree_off_the_threshold(libs, monkeypatch):
    """The two paths round the last step differently (``acc * (1/n)``
    against ``acc / n``), so they may part only where the MAD is within
    rounding of the threshold; on random and flat scenes they are equal."""
    centers = [_scene('random', (96, 80), 0), _scene('flat', (96, 80), 1)]
    natives = [create_mask_texture(c) for c in centers]
    monkeypatch.setenv(native.DISABLE_ENV, '1')
    native.reset()
    try:
        for c, want in zip(centers, natives):
            np.testing.assert_array_equal(create_mask_texture(c), want)
    finally:
        monkeypatch.delenv(native.DISABLE_ENV)
        native.reset()


@pytest.mark.parametrize('f', [1, 2, 3, 4])
def test_strided_window_equals_numpy_and_jax(libs, f):
    rng = np.random.default_rng(f)
    src = rng.random((9, 67, 75, 3), dtype=np.float32)
    win = 16
    for ws_y, ws_x in ((0, 0), (1, 2), ((67 + f - 1) // f - win,
                                         (75 + f - 1) // f - win)):
        got = native.strided_window(src, ws_y, ws_x, f, win)
        want = src[:, ::f, ::f][:, ws_y:ws_y + win, ws_x:ws_x + win]
        np.testing.assert_array_equal(got, want)
        np.testing.assert_array_equal(
            got, jnative.strided_window(src, ws_y, ws_x, f, win))
    with pytest.raises(ValueError, match='leaves'):
        native.strided_window(src, (67 + f - 1) // f - win + 1, 0, f, win)
    with pytest.raises(ValueError, match='leaves'):
        native.strided_window(src, 0, 0, 0, win)


def test_strided_window_declines_other_arrays(libs):
    src = np.zeros((2, 8, 8, 3), np.float64)
    assert native.strided_window(src, 0, 0, 1, 4) is None
    assert native.strided_window(
        np.zeros((2, 8, 8, 6), np.float32)[..., ::2], 0, 0, 1, 4) is None


def test_library_is_the_ports_own_build(libs):
    """The loaded library is built from the port's source under build/,
    never the JAX package's native/ library, and its name carries the
    digest of source, flags and host CPU."""
    path = native.loaded_path()
    assert path == native.library_path()
    assert os.path.commonpath([str(path), os.path.join(REPO, 'build')]) == \
        os.path.join(REPO, 'build')
    assert not str(path).startswith(os.path.join(REPO, 'native'))
    assert native.SOURCE.parent.name == 'csrc_host'
    assert '-ffast-math' not in native.CXX_FLAGS
    assert '-ffp-contract=off' in native.CXX_FLAGS


def test_disable_switch(numpy_only):
    assert native.get_lib() is None
    assert native.texture_mask(np.zeros((4, 4, 3), np.float32), 3,
                               0.1) is None
    assert native.strided_window(np.zeros((1, 4, 4, 3), np.float32), 0, 0,
                                 1, 2) is None
