"""The port's reader of the JAX package's checkpoints
(``mmlf_tpu_torch/utils/msgpack.py``, ``train/checkpoint.load_checkpoint_raw``)
against ``flax.serialization`` on trees flax wrote, and a run directory
that the JAX package trained (only ``checkpoint.msgpack``) validated and
served by both packages."""

import json
import os
import shutil

import jax.numpy as jnp
import msgpack
import numpy as np
import pytest
import torch
from flax import serialization
from hypothesis import given, settings
from hypothesis import strategies as st

from mmlf_tpu.config import Config as JConfig
from mmlf_tpu.data.synth import generate_dataset
from mmlf_tpu.serve import InferenceEngine as JEngine
from mmlf_tpu.train.checkpoint import \
    load_checkpoint_raw as j_load_checkpoint_raw
from mmlf_tpu.train.loop import train as j_train
from mmlf_tpu.validate.cli import run_validation as j_run_validation
from mmlf_tpu_torch.export import export_inference, load_exported
from mmlf_tpu_torch.serve import InferenceEngine
from mmlf_tpu_torch.train.checkpoint import load_checkpoint_raw
from mmlf_tpu_torch.utils.convert import state_dict_from_jax
from mmlf_tpu_torch.utils.msgpack import unpackb
from mmlf_tpu_torch.validate.cli import load_model_state, run_validation

import torch_threads  # noqa: F401  torch's share of the CPUs under xdist

METRICS = ('mse', 'badpix', 'kld', 'kld_mm', 'kld_um', 'nll')


def _same_tree(got, want, path='<root>'):
    """Leaves bit-equal (bf16 as its exact float32), containers alike."""
    if isinstance(want, dict):
        assert isinstance(got, dict) and sorted(got) == sorted(want), path
        for k in want:
            _same_tree(got[k], want[k], f'{path}/{k}')
    elif isinstance(want, list):
        assert isinstance(got, list) and len(got) == len(want), path
        for k, (g, w) in enumerate(zip(got, want)):
            _same_tree(g, w, f'{path}/{k}')
    elif isinstance(want, (np.ndarray, np.generic)):
        if want.dtype == jnp.bfloat16:
            want = want.astype(np.float32)
        assert type(got) is type(want), (path, type(got), type(want))
        assert got.dtype == want.dtype and got.shape == want.shape, path
        assert got.tobytes() == want.tobytes(), path
    else:
        assert type(got) is type(want) and got == want, (path, got, want)


TREES = {
    'nested': {'params': {'a': {'kernel': np.arange(24, dtype=np.float32)
                                .reshape(2, 3, 4)},
                          'b': {'bias': -np.ones(3, np.float32)}}},
    'empty': {'a': {}, 'b': {'c': {}}},
    'dtypes': {'f32': np.float32([1.5, -0.0, np.inf, np.nan, 1e-45]),
               'f64': np.linspace(-1, 1, 7),
               'i32': np.int32([-2**31, 0, 2**31 - 1]),
               'i64': np.int64([-2**63, 2**63 - 1]),
               'bool': np.array([[True], [False]]),
               'u8': np.arange(256, dtype=np.uint8)},
    'bf16': {'w': np.asarray(jnp.asarray(
        np.linspace(-3, 3, 17, dtype=np.float32), jnp.bfloat16))},
    'zero_d': {'f32': np.array(3.25, np.float32),
               'bf16': np.asarray(jnp.bfloat16(-0.5))},
    'python': {'int': 5, 'neg': -33, 'big': 2**40, 'nbig': -2**62,
               'u64': 2**64 - 1, 'float': -0.1, 'none': None, 'yes': True,
               'no': False, 'str': 'ünï', 'long': 'x' * 70000,
               'tuple': (1, 'a', np.float32(2.0))},
}


@pytest.mark.parametrize('name', list(TREES))
def test_decoder_matches_flax(name):
    data = serialization.to_bytes(TREES[name])
    _same_tree(unpackb(data), serialization.msgpack_restore(data))


# written by msgpack_serialize, as flax writes a tree that is not a state
# dict: lists stay msgpack arrays, numpy scalars become ext type 3
RAW_TREES = {
    'lists': {'l': [1, [2.5, None, {'k': np.ones((2, 0), np.float32)}]],
              'bin': b'\x00\xff' * 40000, 'big': list(range(20))},
    'np_scalars': {'f32': np.float32(-1.5), 'i64': np.int64(-7),
                   'bool': np.bool_(True), 'bf16': jnp.bfloat16(2.5),
                   'f64': np.float64(1e300)},
}


@pytest.mark.parametrize('name', list(RAW_TREES))
def test_decoder_matches_flax_on_raw_trees(name):
    data = serialization.msgpack_serialize(RAW_TREES[name])
    _same_tree(unpackb(data), serialization.msgpack_restore(data))


_leaf = st.one_of(
    st.integers(-2**63, 2**64 - 1), st.floats(allow_nan=False), st.none(),
    st.booleans(), st.text(max_size=40),
    st.lists(st.floats(width=32, allow_nan=False), max_size=20).map(
        lambda v: np.asarray(v, np.float32)),
    st.lists(st.integers(-2**31, 2**31 - 1), max_size=20).map(
        lambda v: np.asarray(v, np.int32)),
    st.floats(width=32, allow_nan=False).map(np.float32))
_tree = st.recursive(_leaf, lambda kids: st.dictionaries(
    st.text(min_size=1, max_size=8), kids, max_size=5), max_leaves=30)


@settings(max_examples=60, deadline=None)
@given(st.dictionaries(st.text(min_size=1, max_size=8), _tree, max_size=5))
def test_decoder_matches_flax_on_random_trees(tree):
    data = serialization.to_bytes(tree)
    _same_tree(unpackb(data), serialization.msgpack_restore(data))


@pytest.mark.parametrize('blob,match', [
    (serialization.msgpack_serialize({'a': {'b': 1 + 2j}}),
     'a/b: a complex leaf'),
    (msgpack.packb({'a': {'w': msgpack.ExtType(9, b'xyz')}}),
     'a/w: unknown msgpack ext type 9'),
    (msgpack.packb({'p': {'w': {'__msgpack_chunked_array__': True,
                                'shape': {'0': 2}}}}),
     'p/w: a chunked leaf'),
    (serialization.to_bytes({'a': np.ones(8, np.float32)})[:-3],
     'ends early'),
    (serialization.to_bytes({'a': 1}) + b'\x00', 'bytes after'),
], ids=['complex', 'unknown_ext', 'chunked', 'truncated', 'trailing'])
def test_decoder_rejects(blob, match):
    with pytest.raises(ValueError, match=match):
        unpackb(blob)


@pytest.fixture(scope='module')
def jax_run(tmp_path_factory):
    """A run directory that the JAX package trained for 2 steps: only
    ``checkpoint.msgpack`` and ``hyper_parameters.json``."""
    root = tmp_path_factory.mktemp('torch_msgpack')
    data = str(root / 'data')
    generate_dataset(data, scenes=1, size=64, seed=0)
    out = str(root / 'run')
    os.makedirs(out)
    cfg = JConfig(
        train_trainset=data, train_valset=data,
        train_bs=2, train_ps=32, train_lr=1e-3, train_max_downscale=1,
        val_interval=2, train_steps=2, model_chs=6, model_in_blocks=1,
        model_out_blocks=2, model_uncert=True, val_loss_margin=5,
    ).finalize()
    j_train(cfg, out, progress=False)
    assert not os.path.exists(os.path.join(out, 'checkpoint.pt'))
    return data, out


def test_load_model_state_matches_jax_restore(jax_run):
    _, run = jax_run
    tree, meta, hyper = load_checkpoint_raw(run)
    j_tree, j_meta, j_hyper = j_load_checkpoint_raw(run)
    assert hyper == j_hyper
    _same_tree(meta, j_meta)
    _same_tree(tree, j_tree)       # the optimizer state too

    state, stored = load_model_state(run)
    assert stored == j_hyper
    want = state_dict_from_jax({'params': j_tree['params'],
                                'batch_stats': j_tree['batch_stats']},
                               j_hyper)
    assert sorted(state) == sorted(want)
    for k in want:
        assert torch.equal(state[k], want[k]), k


@pytest.mark.parametrize('ens', [False, True], ids=['upr', 'ese'])
def test_validate_msgpack_run_dir_matches_jax(jax_run, tmp_path, ens):
    """Both validate CLIs on the JAX-trained run directory, with the
    metric tolerances of tests/test_torch_validate.py."""
    data, run = jax_run
    runs = []
    for name in ('jax', 'torch'):
        runs.append(str(tmp_path / name))
        shutil.copytree(run, runs[-1])
    # the ensemble at 7 members, as tests/test_export.py runs it
    kw = dict(val_loss_margin=15, val_ensamble=ens, val_disp_step=1.0)
    want = j_run_validation(runs[0], data, **kw)
    got = run_validation(runs[1], data, device='cpu', **kw)
    for k in METRICS:
        assert np.isfinite(got[k]), k
        assert got[k] == pytest.approx(want[k], rel=1e-3, abs=1e-6), k


def test_serve_msgpack_run_dir_matches_jax(jax_run):
    data, run = jax_run
    scene = os.path.join(data, 'scene_00')
    got = InferenceEngine(run, device='cpu').infer(scene, train_shift=0.5)
    want = JEngine(run).infer(scene, train_shift=0.5)
    assert got['shape'] == want['shape'] == [64, 64]
    for k in ('mse', 'badpix_007'):
        assert got[k] == pytest.approx(want[k], rel=1e-3, abs=1e-6), k


def test_bf16_run_dir_validates_exports_and_serves_like_jax(jax_run,
                                                            tmp_path):
    """A JAX ``--bf16`` run directory (here the trained run with ``bf16``
    in its stored config): both validate CLIs evaluate it with the bf16
    trunk and agree, the port's tiled ESE and its export run it in bf16,
    and both servers answer for it.  bf16 rounds, so the metrics within
    1e-2 relative (tests/test_torch_bf16.py)."""
    data, run = jax_run
    dirs = []
    for name in ('jax', 'torch'):
        dirs.append(str(tmp_path / name))
        shutil.copytree(run, dirs[-1])
        path = os.path.join(dirs[-1], 'hyper_parameters.json')
        with open(path) as f:
            hyper = json.load(f)
        with open(path, 'w') as f:
            json.dump(dict(hyper, bf16=True), f)
    kw = dict(val_loss_margin=15, val_ensamble=True, val_disp_step=1.0)
    want = j_run_validation(dirs[0], data, **kw)
    got = run_validation(dirs[1], data, device='cpu', **kw)
    for k in METRICS:
        assert np.isfinite(got[k]), k
        assert got[k] == pytest.approx(want[k], rel=1e-2, abs=1e-6), k
    tiled = run_validation(dirs[1], data, device='cpu', val_tile=32, **kw)
    assert all(np.isfinite(tiled[k]) for k in METRICS)
    _, meta = load_exported(export_inference(dirs[1], 64, 64), device='cpu')
    assert meta['dtype'] == 'bfloat16'
    engine = InferenceEngine(dirs[1], device='cpu')
    assert engine.meta['dtype'] == 'bfloat16'
    scene = os.path.join(data, 'scene_00')
    served = engine.infer(scene)
    want = JEngine(dirs[0]).infer(scene)
    for k in ('mse', 'badpix_007'):
        assert served[k] == pytest.approx(want[k], rel=1e-2, abs=1e-6), k


def test_bf16_inn_run_dir_validates_like_jax(jax_run, tmp_path):
    """A JAX-initialised ``--model_inn --bf16`` run directory goes through
    both validate CLIs on the trained run's scene, the metrics within
    1e-2 relative."""
    import jax
    from mmlf_tpu.models.inn import INN as JINN
    from mmlf_tpu.train import checkpoint as jckpt
    data, _ = jax_run
    jcfg = JConfig(model_views=9, model_in_blocks=1, model_out_blocks=1,
                   model_inn=True, bf16=True).finalize()
    variables = jax.device_get(dict(jax.jit(JINN.from_config(jcfg).init)(
        jax.random.PRNGKey(0), *[jnp.zeros((1, 9, 16, 16, 3))] * 4)))
    inn = [str(tmp_path / f'inn_{name}') for name in ('jax', 'torch')]
    for d in inn:
        os.makedirs(d)
        jckpt.save_checkpoint(d, variables, jcfg.to_dict(), 0, 0, 0.0)
    want = j_run_validation(inn[0], data, val_loss_margin=15)
    got = run_validation(inn[1], data, device='cpu', val_loss_margin=15)
    for k in METRICS:
        assert np.isfinite(got[k]), k
        assert got[k] == pytest.approx(want[k], rel=1e-2, abs=1e-6), k
