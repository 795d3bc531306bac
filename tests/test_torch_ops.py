"""Port ops against the JAX package: codecs, masks, EPI-Shift, the static
Shift transform and scene loading (fp32, numpy-seeded inputs)."""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from mmlf_tpu.data import transforms as jT
from mmlf_tpu.data.hci4d import load_scene as j_load_scene
from mmlf_tpu.data.synth import generate_dataset
from mmlf_tpu.ops import codecs as jC
from mmlf_tpu.ops import masks as jM
from mmlf_tpu.ops import shift as jS
from mmlf_tpu_torch.data import transforms as tT
from mmlf_tpu_torch.data.hci4d import load_scene as t_load_scene
from mmlf_tpu_torch.ops import codecs as tC
from mmlf_tpu_torch.ops import masks as tM
from mmlf_tpu_torch.ops import shift as tS

import torch_threads  # noqa: F401  torch's share of the CPUs under xdist


@pytest.mark.parametrize('n_steps', [36, 70, 108])
def test_codecs_match_jax(n_steps):
    rng = np.random.default_rng(n_steps)
    lo, hi = -3.5, 3.5
    np.testing.assert_allclose(tC.bin_centers(lo, hi, n_steps).numpy(),
                               np.asarray(jC.bin_centers(lo, hi, n_steps)),
                               rtol=0, atol=1e-6)

    x = rng.uniform(-4, 4, (2, 9, 11)).astype(np.float32)
    got = tC.reg_to_class(torch.from_numpy(x), lo, hi, n_steps).numpy()
    want = np.asarray(jC.reg_to_class(jnp.asarray(x), lo, hi, n_steps))
    np.testing.assert_array_equal(got, want)
    assert got.sum() > 0

    hot = (rng.random((2, 9, 11, n_steps)) < 0.05).astype(np.float32)
    np.testing.assert_allclose(
        tC.class_to_reg(torch.from_numpy(hot), lo, hi, n_steps).numpy(),
        np.asarray(jC.class_to_reg(jnp.asarray(hot), lo, hi, n_steps)),
        rtol=0, atol=1e-5)

    mpi = rng.uniform(0, 1, (2, 3, 9, 11, 5)).astype(np.float32)
    mpi[..., 4] = rng.uniform(-3.5, 3.5, (2, 3, 9, 11))
    np.testing.assert_allclose(
        tC.mpi_to_weights(torch.from_numpy(mpi), lo, hi, n_steps).numpy(),
        np.asarray(jC.mpi_to_weights(jnp.asarray(mpi), lo, hi, n_steps)),
        rtol=0, atol=1e-6)


@pytest.mark.parametrize('shape,margin', [((1, 20, 24), 0), ((1, 20, 24), 5),
                                          ((2, 31, 17), 7), ((64, 64), 15)])
def test_mask_margin_matches_jax(shape, margin):
    got = tM.create_mask_margin(shape, margin).numpy()
    np.testing.assert_array_equal(
        got, np.asarray(jM.create_mask_margin(shape, margin)))
    np.testing.assert_array_equal(tM.create_mask_margin_np(shape, margin),
                                  jM.create_mask_margin_np(shape, margin))


def test_mask_texture_matches_jax():
    rng = np.random.default_rng(3)
    center = (rng.random((40, 56, 3), dtype=np.float32) * 0.3)
    center[:, :20] *= 0.02                 # a flat region the mask drops
    got = tM.create_mask_texture(center)
    want = jM.create_mask_texture(center)
    np.testing.assert_array_equal(got, want)
    assert 0 < got.mean() < 1


def _rand_stacks(rng, b=None, n=9, h=12, w=14):
    lead = () if b is None else (b,)
    return [rng.random(lead + (n, h, w, 3), dtype=np.float32)
            for _ in range(4)]


@pytest.mark.parametrize('disp', [0.0, 1.0, -1.0, 0.5, -0.5, 2.5, -2.5, 0.3,
                                  -0.3, 1.7, -1.7, 3.0, -3.4999998])
def test_shift_lf_matches_jax(disp):
    rng = np.random.default_rng(0)
    stacks = _rand_stacks(rng, b=1)
    got = tS.shift_lf(*[torch.from_numpy(s) for s in stacks],
                      np.float32(disp))
    want = jS.shift_lf(*[jnp.asarray(s) for s in stacks], np.float32(disp))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=0,
                                   atol=1e-6)


def test_modf_signed_zero():
    """s = -0.3: trunc gives -0.0, so shift1 must be -1 (not +1)."""
    for s in (-0.3, 0.3, -1.7, 2.0, -0.0):
        alpha, s0, s1 = tS.modf_shift_components(np.float32(s))
        ja, j0, j1 = jS.modf_shift_components(np.float32(s))
        assert float(alpha) == pytest.approx(float(ja), abs=1e-7)
        assert (int(s0), int(s1)) == (int(j0), int(j1)), s
    assert int(tS.modf_shift_components(np.float32(-0.3))[2]) == -1
    assert int(tS.modf_shift_components(np.float32(0.3))[2]) == 1


@pytest.fixture(scope='module')
def scene_dir(tmp_path_factory):
    root = str(tmp_path_factory.mktemp('torch_ops_scene'))
    generate_dataset(root, scenes=1, size=48, seed=2)
    return root + '/scene_00'


def test_load_scene_and_shift_match_jax(scene_dir):
    got = t_load_scene(scene_dir)
    want = j_load_scene(scene_dir)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(np.asarray(g), np.asarray(w))
    assert got[6].shape[0] >= 2                       # a multi-plane MPI

    for disp in (0.0, 2.5, -1.3):
        gs = tT.Shift(disp)(got)
        ws = jT.Shift(disp)(want)
        for g, w in zip(gs, ws):
            np.testing.assert_allclose(np.asarray(g), np.asarray(w),
                                       rtol=0, atol=1e-6)
