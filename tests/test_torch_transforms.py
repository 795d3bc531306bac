"""The port's transforms library (``mmlf_tpu_torch/data/transforms.py``)
against ``mmlf_tpu.data.transforms`` on a synthetic 9-tuple: each transform,
and a chain of all of them, under the same seeded stdlib ``random`` and
``np.random`` globals, field by field and bit for bit."""

import random

import numpy as np
import pytest

from mmlf_tpu.data import transforms as JT
from mmlf_tpu_torch.data import transforms as T

import torch_threads  # noqa: F401  torch's share of the CPUs under xdist


def _sample(seed: int = 0, n: int = 5, h: int = 26, w: int = 30, k: int = 3):
    rng = np.random.default_rng(seed)

    def f32(*shape):
        return rng.random(shape, dtype=np.float32)

    mpi = f32(k, h, w, 5)
    mpi[..., 4] = rng.uniform(-3, 3, (k, h, w)).astype(np.float32)
    return (f32(n, h, w, 3), f32(n, h, w, 3), f32(n, h, w, 3),
            f32(n, h, w, 3), f32(h, w, 3),
            rng.uniform(-3, 3, (h, w)).astype(np.float32), mpi,
            (rng.random((h, w)) > 0.3).astype(np.int32), 4)


def _run(transform, data, seed: int):
    random.seed(seed)
    np.random.seed(seed)
    out = transform(data)
    # the globals advanced alike: the next draws agree too
    return out, (random.random(), np.random.random())


def _assert_same(got, want):
    assert len(got) == len(want)
    for j, (g, w) in enumerate(zip(got, want)):
        if isinstance(w, np.ndarray):
            assert isinstance(g, np.ndarray) and g.dtype == w.dtype, j
            np.testing.assert_array_equal(g, w, err_msg=f'field {j}')
        else:
            assert g == w, j


# (name, constructor arguments): each built from both modules
CASES = [
    ('Zoom', (0.5,)), ('Zoom', (0.77,)), ('Zoom', (1.37,)),
    ('RandomZoom', ()), ('RandomZoom', (0.3, 1.8)),
    ('DownSampling', (1,)), ('DownSampling', (3,)),
    ('RandomDownSampling', ()), ('RandomDownSampling', (2,)),
    ('Crop', (12, (3, 5))), ('Crop', ((10, 14), (0, 7))),
    ('CenterCrop', (16,)), ('CenterCrop', ((13, 21),)),
    ('RandomCrop', (16,)), ('RandomCrop', (12, 2)),
    ('RedistColor', ()), ('Contrast', ()), ('Contrast', (0.3,)),
    ('Brightness', ()), ('Brightness', (0.5,)), ('Noise', ()),
    ('Noise', (0.2,)), ('Shift', (1.5,)), ('Shift', (-0.7,)),
    ('IntegerShift', (2,)), ('RandomShift', (1,)),
    ('RandomShift', ((-2.0, 0.5),)), ('Rotate90', ()), ('RandomRotate', ()),
]


@pytest.mark.parametrize('name,args', CASES,
                         ids=[f'{n}{a}' for n, a in CASES])
@pytest.mark.parametrize('seed', [0, 3])
def test_transform_matches_jax(name, args, seed):
    data = _sample(seed)
    got = _run(getattr(T, name)(*args), data, seed)
    want = _run(getattr(JT, name)(*args), data, seed)
    _assert_same(got[0], want[0])
    assert got[1] == want[1]


def test_chain_matches_jax():
    """The reference chain with every random transform, as a ``Compose``."""
    def chain(M):
        return M.Compose([M.RandomZoom(0.6, 1.4), M.RandomDownSampling(2),
                          M.RandomShift(1), M.RandomCrop(12),
                          M.CenterCrop(10), M.RandomRotate(),
                          M.RedistColor(), M.Brightness(), M.Contrast(),
                          M.Noise()])

    for seed in range(6):
        data = _sample(seed, h=40, w=44)
        got = _run(chain(T), data, seed)
        want = _run(chain(JT), data, seed)
        _assert_same(got[0], want[0])
        assert got[1] == want[1]


def test_rotate90_leaves_the_mask_alone():
    """The reference quirk, kept: stacks, centre, gt and MPI rotate and the
    stacks swap; the mask does not move."""
    data = _sample(1)
    out = T.Rotate90()(data)
    np.testing.assert_array_equal(out[7], data[7])
    np.testing.assert_array_equal(out[5], np.rot90(data[5]))
    np.testing.assert_array_equal(out[0], data[1].transpose(0, 2, 1, 3)[
        :, ::-1])
    four = data
    for _ in range(4):
        four = T.Rotate90()(four)
    _assert_same(four, data)


def test_helpers_match_jax():
    data = _sample(2)
    mat = T.random_color_matrix(np.random.default_rng(5))
    np.testing.assert_array_equal(
        mat, JT.random_color_matrix(np.random.default_rng(5)))
    np.testing.assert_array_equal(T.apply_color_matrix(data[0], mat),
                                  JT.apply_color_matrix(data[0], mat))
    for idx, h_ax in ((0, -3), (4, -3), (5, -2), (6, -3)):
        np.testing.assert_array_equal(T.rot90_field(data[idx], h_ax),
                                      JT.rot90_field(data[idx], h_ax))
    assert T._spatial_fields(data) == JT._spatial_fields(data)
    random.seed(9)
    a = T.random_color_matrix()
    random.seed(9)
    np.testing.assert_array_equal(a, JT.random_color_matrix())


@pytest.mark.parametrize('name,args', [('CenterCrop', (40,)),
                                       ('RandomCrop', (26,))])
def test_crops_too_large_raise_like_jax(name, args):
    data = _sample(0)
    with pytest.raises(AssertionError):
        getattr(JT, name)(*args)(data)
    with pytest.raises(ValueError, match=name):
        getattr(T, name)(*args)(data)
