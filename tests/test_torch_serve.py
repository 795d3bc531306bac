"""The port's inference server (``mmlf_tpu_torch/serve.py``) against
``mmlf_tpu.serve`` on the same run directory and synthetic scenes: each
served response (metrics, ``result.pfm``, ``uncert.pfm``, the health
record) held against the JAX engine's, in run-directory and artifact
modes, batched, u8, shifted and tiled, plus the guards and two requests
at once."""

import json
import os
import threading
import urllib.request

import numpy as np
import pytest

from mmlf_tpu.config import Config as JConfig
from mmlf_tpu.data.synth import generate_dataset
from mmlf_tpu.export import export_inference as j_export_inference
from mmlf_tpu.serve import InferenceEngine as JEngine
from mmlf_tpu.serve import make_server as j_make_server
from mmlf_tpu.utils.convert import (save_reference_checkpoint,
                                    torch_state_to_flax)
from mmlf_tpu_torch.config import Config
from mmlf_tpu_torch.export import export_inference
from mmlf_tpu_torch.models.feed_forward import FeedForward, init_live_
from mmlf_tpu_torch.serve import InferenceEngine, main, make_server
from mmlf_tpu_torch.utils import pfm

import torch_threads  # noqa: F401  torch's share of the CPUs under xdist

# the served metrics and result.pfm against the JAX package's
# (tests/test_torch_validate.py)
METRIC_REL = 1e-3
PFM_ATOL = 5e-4


def write_checkpoint(path):
    """A reference-format ``checkpoint.pt`` of a narrow UPR net with live
    random weights (BatchNorm included), readable by both packages."""
    cfg = Config(model_chs=8, model_views=9, model_in_blocks=1,
                 model_out_blocks=2, model_uncert=True).finalize()
    live = init_live_(FeedForward.from_config(cfg), seed=11)
    variables = torch_state_to_flax(
        {k: v.numpy() for k, v in live.state_dict().items()},
        in_blocks=cfg.model_in_blocks, out_blocks=cfg.model_out_blocks)
    os.makedirs(path, exist_ok=True)
    save_reference_checkpoint(os.path.join(path, 'checkpoint.pt'),
                              variables, JConfig.from_dict(cfg.to_dict()))
    return path


@pytest.fixture(scope='module')
def env(tmp_path_factory):
    root = tmp_path_factory.mktemp('torch_serve')
    data = str(root / 'data')
    generate_dataset(data, scenes=1, size=64, seed=0)
    ckpt = write_checkpoint(str(root / 'run'))
    scene = os.path.join(data, sorted(os.listdir(data))[0])
    return root, ckpt, scene


def _artifacts(tmp_path, ckpt, name, **kw):
    """The port's and the JAX package's artifact for the same options."""
    port = str(tmp_path / f'{name}.mmlft')
    jax_ = str(tmp_path / f'{name}.mmlf')
    with open(port, 'wb') as f:
        f.write(export_inference(ckpt, **kw))
    with open(jax_, 'wb') as f:
        f.write(j_export_inference(ckpt, platforms=('cpu',), **kw))
    return port, jax_


def _request(port, method, path, payload=None):
    url = f'http://127.0.0.1:{port}{path}'
    data = None if payload is None else json.dumps(payload).encode()
    req = urllib.request.Request(url, data=data, method=method)
    try:
        with urllib.request.urlopen(req) as r:
            return r.status, json.loads(r.read())
    except urllib.error.HTTPError as e:
        return e.code, json.loads(e.read())


class Served:
    """An engine behind an HTTP server on an ephemeral port."""

    def __init__(self, engine, make=make_server):
        self.engine = engine
        self.srv = make(engine, port=0)
        threading.Thread(target=self.srv.serve_forever, daemon=True).start()
        self.port = self.srv.server_address[1]

    def __call__(self, method, path, payload=None):
        return _request(self.port, method, path, payload)

    def close(self):
        self.srv.shutdown()
        self.srv.server_close()


def _same_response(got, want, got_dir=None, want_dir=None):
    """A served response against the JAX engine's: metrics, shape and the
    PFM artifacts."""
    assert got['shape'] == want['shape']
    for k in ('mse', 'badpix_007'):
        assert (k in got) == (k in want), k
        if k in want:
            assert got[k] == pytest.approx(want[k], rel=METRIC_REL,
                                           abs=1e-6), k
    if got_dir is None:
        return
    assert [os.path.basename(a) for a in got['artifacts']] == \
        [os.path.basename(a) for a in want['artifacts']]
    for name in [os.path.basename(a) for a in want['artifacts']]:
        np.testing.assert_allclose(pfm.load(os.path.join(got_dir, name)),
                                   pfm.load(os.path.join(want_dir, name)),
                                   atol=PFM_ATOL, err_msg=name)


@pytest.mark.parametrize('case', ['upr', 'ese', 'ese_calibrated'])
def test_healthz_matches_jax(env, case):
    root, ckpt, _ = env
    kw = {}
    if case != 'upr':
        kw['val_ensamble'] = True
    if case == 'ese_calibrated':
        cal = str(root / 'cal.json')
        with open(cal, 'w') as f:
            json.dump({'rank_corr': 0.8, 'bare_mse': 0.1, 'ese_mse': 0.05,
                       'calibrated': True, 'member_offsets': None}, f)
        kw['calibration'] = cal
    got = Served(InferenceEngine(ckpt, device='cpu', **kw))
    want = Served(JEngine(ckpt, **kw), j_make_server)
    try:
        code, body = got('GET', '/healthz')
        assert code == 200 and body == want('GET', '/healthz')[1]
        if case == 'ese':
            assert body['calibration']['status'] == 'unchecked'
        if case == 'ese_calibrated':
            assert body['calibration']['calibrated'] is True
            assert body['calibration']['recalibrated'] is False
        assert got('GET', '/stats') == (200, {
            'requests': 0, 'errors': 0, 'total_s': 0.0, 'last_s': None,
            'avg_s': 0.0})
    finally:
        got.close()
        want.close()


@pytest.mark.parametrize('mode', ['run_dir', 'artifact', 'ese_artifact'])
def test_infer_matches_jax(env, tmp_path, mode):
    root, ckpt, scene = env
    if mode == 'run_dir':
        engine, j_engine = InferenceEngine(ckpt, device='cpu'), JEngine(ckpt)
    else:
        kw = dict(val_ensamble=True, val_disp_step=1.0) \
            if mode == 'ese_artifact' else {}
        port, jax_ = _artifacts(tmp_path, ckpt, mode, height=64, width=64,
                                **kw)
        engine, j_engine = InferenceEngine(port, device='cpu'), JEngine(jax_)
        assert engine.warmup() == (64, 64)
    served = Served(engine)
    try:
        out, j_out = str(tmp_path / 'out'), str(tmp_path / 'j_out')
        code, got = served('POST', '/infer',
                           {'scene_dir': scene, 'out_dir': out})
        assert code == 200, got
        want = j_engine.infer(scene, out_dir=j_out)
        assert got['shape'] == [64, 64] and np.isfinite(got['mse'])
        _same_response(got, want, out, j_out)
        res = np.flip(pfm.load(os.path.join(out, 'result.pfm')), 0)
        assert res.shape == (64, 64) and np.isfinite(res).all()
        code, stats = served('GET', '/stats')
        assert code == 200 and stats['requests'] == 1 and \
            stats['errors'] == 0 and stats['last_s'] == got['runtime_s']
    finally:
        served.close()


def test_infer_bad_request(env):
    _, ckpt, _ = env
    served = Served(InferenceEngine(ckpt, device='cpu'))
    try:
        code, resp = served('POST', '/infer',
                            {'scene_dir': '/nonexistent/scene'})
        assert code == 400 and resp['error'].startswith('FileNotFoundError')
        code, _ = served('POST', '/nope')
        assert code == 404
        code, _ = served('GET', '/nope')
        assert code == 404
        # non-object JSON bodies get a clean 400, not a dropped connection
        for body in ([1], 'x', 3, None, {}):
            code, resp = served('POST', '/infer', body)
            assert code == 400 and 'error' in resp, body
        code, stats = served('GET', '/stats')
        assert stats['requests'] == 6 and stats['errors'] == 6
    finally:
        served.close()


def test_batched_artifact_matches_jax(env, tmp_path):
    """--batch 2 artifacts serve single scenes (zero-padded) and scene
    lists, into per-scene subdirectories; run-directory mode has no batch
    limit."""
    root, ckpt, scene = env
    port, jax_ = _artifacts(tmp_path, ckpt, 'b2', height=64, width=64,
                            batch=2)
    engine, j_engine = InferenceEngine(port, device='cpu'), JEngine(jax_)
    assert engine.warmup() == (64, 64)

    single = engine.infer(scene)
    _same_response(single, j_engine.infer(scene))

    out, j_out = str(tmp_path / 'multi'), str(tmp_path / 'j_multi')
    multi = engine.infer(out_dir=out, scene_dirs=[scene, scene])
    j_multi = j_engine.infer(out_dir=j_out, scene_dirs=[scene, scene])
    assert len(multi['scenes']) == 2 and 'runtime_s' in multi
    name = multi['scenes'][0]['scene']
    for r, jr in zip(multi['scenes'], j_multi['scenes']):
        assert r['mse'] == pytest.approx(single['mse'], rel=1e-6)
        _same_response(r, jr, os.path.join(out, name),
                       os.path.join(j_out, name))
    assert os.path.dirname(multi['scenes'][0]['artifacts'][0]) == \
        os.path.join(out, name)

    with pytest.raises(ValueError, match='artifact batch is 2'):
        engine.infer(scene_dirs=[scene, scene, scene])
    with pytest.raises(ValueError, match='non-empty list'):
        engine.infer(scene_dirs=[])

    multi_ck = InferenceEngine(ckpt, device='cpu').infer(
        scene_dirs=[scene, scene, scene])
    assert len(multi_ck['scenes']) == 3
    assert multi_ck['scenes'][2]['mse'] == pytest.approx(single['mse'],
                                                         rel=1e-6)


def test_data_root_confinement(env):
    root, ckpt, scene = env
    engine = InferenceEngine(ckpt, data_root=str(root), device='cpu')
    assert np.isfinite(engine.infer(scene)['disp']['mean'])
    with pytest.raises(ValueError, match='outside --data_root'):
        engine.infer('/etc')
    with pytest.raises(ValueError, match='outside --data_root'):
        engine.infer(scene, out_dir='/tmp/elsewhere')


def test_artifact_shape_guard(env, tmp_path):
    root, ckpt, scene = env
    port, _ = _artifacts(tmp_path, ckpt, 'm32', height=32, width=32)
    engine = InferenceEngine(port, device='cpu')
    assert engine.fixed_shape == (32, 32) and engine.warmup() == (32, 32)
    with pytest.raises(ValueError, match='specialized to'):
        engine.infer(scene)


def test_u8_matches_fp32_and_jax(env, tmp_path):
    """u8 artifacts (uint8 views, normalized and shifted on the device)
    reproduce the fp32 path's metrics and the JAX u8 artifact's; run-
    directory --u8 mode agrees too; --u8 cannot retrofit an fp32
    artifact."""
    root, ckpt, scene = env
    port, jax_ = _artifacts(tmp_path, ckpt, 'u8', height=64, width=64,
                            u8=True)
    ref = InferenceEngine(ckpt, device='cpu').infer(scene, train_shift=1.5)

    engine = InferenceEngine(port, device='cpu')
    assert engine.u8 and engine.warmup() == (64, 64)
    out, j_out = str(tmp_path / 'out_u8'), str(tmp_path / 'j_out_u8')
    got = engine.infer(scene, out_dir=out, train_shift=1.5)
    # PNG-decoded views are exactly uint8/255 on both paths
    assert got['mse'] == pytest.approx(ref['mse'], rel=1e-5)
    assert got['badpix_007'] == pytest.approx(ref['badpix_007'], abs=1e-6)
    _same_response(got, JEngine(jax_).infer(scene, out_dir=j_out,
                                            train_shift=1.5), out, j_out)

    ck = InferenceEngine(ckpt, u8=True, device='cpu')
    assert ck.u8
    assert ck.infer(scene, train_shift=1.5)['mse'] == \
        pytest.approx(ref['mse'], rel=1e-5)

    fp32, _ = _artifacts(tmp_path, ckpt, 'fp32', height=64, width=64)
    with pytest.raises(ValueError, match='not exported with --u8'):
        InferenceEngine(fp32, u8=True, device='cpu')


def test_train_shift_matches_jax(env):
    """A nonzero shift re-centres the stacks (and the GT): the output
    changes, as the JAX engine's does."""
    root, ckpt, scene = env
    engine, j_engine = InferenceEngine(ckpt, device='cpu'), JEngine(ckpt)
    r0 = engine.infer(scene)
    r1 = engine.infer(scene, train_shift=1.0)
    assert r0['disp'] != r1['disp']
    _same_response(r1, j_engine.infer(scene, train_shift=1.0))
    default = InferenceEngine(ckpt, train_shift=1.0, device='cpu')
    assert default.infer(scene)['disp'] == r1['disp']


def test_nonloopback_requires_data_root(env):
    from click.testing import CliRunner
    root, ckpt, scene = env
    res = CliRunner().invoke(main, [ckpt, '--host', '0.0.0.0',
                                    '--no_warmup', '--device', 'cpu'])
    assert res.exit_code != 0
    assert 'data_root is required' in res.output
    # loopback starts without confinement: the engine builds, then the
    # bind on a bad port fails
    res = CliRunner().invoke(main, [ckpt, '--port', '-1', '--no_warmup',
                                    '--device', 'cpu'])
    assert res.exit_code != 0 and 'data_root is required' not in res.output
    assert isinstance(res.exception, OverflowError)


def test_tiled_artifact_serves_shapes_like_jax(env, tmp_path):
    """A --tiled artifact serves scenes of several shapes, equal to the
    fixed-shape artifact (UPR tiles exactly) and to the JAX tiled
    artifact; a scene smaller than one window is a client error."""
    root, ckpt, scene = env
    data = str(root / 'data_shapes')
    if not os.path.exists(data):
        generate_dataset(data + '96', scenes=1, size=96, seed=3)
        generate_dataset(data + '40', scenes=1, size=40, seed=4)
    scene96 = os.path.join(data + '96', 'scene_00')
    scene40 = os.path.join(data + '40', 'scene_00')

    port, jax_ = _artifacts(tmp_path, ckpt, 'tiled', height=0, width=0,
                            tiled=32)
    engine, j_engine = InferenceEngine(port, device='cpu'), JEngine(jax_)
    assert engine.fixed_shape is None and engine.tiled == 32
    assert engine.warmup() is None and engine.warmup(64) == (64, 64)
    for sd, size in ((scene, 64), (scene96, 96)):
        out, j_out = str(tmp_path / f'o{size}'), str(tmp_path / f'j{size}')
        got = engine.infer(scene_dir=sd, out_dir=out)
        assert got['shape'] == [size, size]
        _same_response(got, j_engine.infer(scene_dir=sd, out_dir=j_out),
                       out, j_out)

    fixed, _ = _artifacts(tmp_path, ckpt, 'fixed', height=64, width=64)
    rf = InferenceEngine(fixed, device='cpu').infer(scene_dir=scene)
    assert engine.infer(scene_dir=scene)['mse'] == \
        pytest.approx(rf['mse'], abs=1e-6)

    served = Served(engine)
    try:
        code, resp = served('POST', '/infer', {'scene_dir': scene40})
        assert code == 400 and 'smaller than the tile window' in \
            resp['error']
    finally:
        served.close()


def test_concurrent_requests_match_serial(env, tmp_path):
    """Two requests at once, each on a server thread of its own: both
    answers equal the serial ones, and no output of a device call records
    autograd history (grad mode is thread-local)."""
    root, ckpt, scene = env
    engine = InferenceEngine(ckpt, device='cpu')
    outputs = []
    call = engine._call

    def recording(*args):
        out = call(*args)
        outputs.append(out)
        return out
    engine._call = recording

    serial = [engine.infer(scene, train_shift=s) for s in (0.0, 1.0)]
    served = Served(engine)
    answers = [None, None]

    def ask(k, shift):
        answers[k] = served('POST', '/infer', {'scene_dir': scene,
                                               'train_shift': shift})
    try:
        threads = [threading.Thread(target=ask, args=(k, s))
                   for k, s in enumerate((0.0, 1.0))]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=120)
            assert not t.is_alive()
    finally:
        served.close()
    for (code, got), want in zip(answers, serial):
        assert code == 200, got
        assert got['disp'] == want['disp']
        assert got['mse'] == want['mse']
    assert len(outputs) == 4
    assert not any(v.requires_grad for out in outputs for v in out.values())
