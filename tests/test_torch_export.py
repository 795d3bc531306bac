"""The port's export artifacts (``mmlf_tpu_torch/export.py``) against its
own direct path and against ``mmlf_tpu.export`` on the same
reference-format ``checkpoint.pt``: UPR and ESE (with and without the
member stacks, with calibration offsets), u8 ingest, tiled artifacts,
and the container's guards."""

import os

import jax
import numpy as np
import pytest
import torch

from mmlf_tpu.config import Config as JConfig
from mmlf_tpu.export import build_inference as j_build_inference
from mmlf_tpu.export import export_inference as j_export_inference
from mmlf_tpu.export import load_exported as j_load_exported
from mmlf_tpu.utils.convert import (save_reference_checkpoint,
                                    torch_state_to_flax)
from mmlf_tpu.validate.tiling import tile_positions as j_tile_positions
from mmlf_tpu_torch.config import Config
from mmlf_tpu_torch.data.transforms import np_shift_lf
from mmlf_tpu_torch.export import (build_inference, export_inference,
                                   inference_fn, load_exported, main)
from mmlf_tpu_torch.models.feed_forward import FeedForward, init_live_

import torch_threads  # noqa: F401  torch's share of the CPUs under xdist

SMALL = dict(model_chs=8, model_views=9, model_in_blocks=1,
             model_out_blocks=2, model_uncert=True)
# the ensemble at 7 members (arange(-3.5, 3.5, 1.0)), as test_export.py
ESE = dict(val_ensamble=True, val_disp_step=1.0)
# the port's forward against the JAX package's (tests/test_torch_model.py)
ATOL = 5e-4


def write_checkpoint(path, seed=11, **cfg_kw):
    """A reference-format ``checkpoint.pt`` of a narrow UPR net with live
    random weights (BatchNorm included), readable by both packages."""
    cfg = Config(**{**SMALL, **cfg_kw}).finalize()
    live = init_live_(FeedForward.from_config(cfg), seed=seed)
    variables = torch_state_to_flax(
        {k: v.numpy() for k, v in live.state_dict().items()},
        in_blocks=cfg.model_in_blocks, out_blocks=cfg.model_out_blocks)
    os.makedirs(path, exist_ok=True)
    save_reference_checkpoint(os.path.join(path, 'checkpoint.pt'),
                              variables, JConfig.from_dict(cfg.to_dict()))
    return path


@pytest.fixture(scope='module')
def ckpt(tmp_path_factory):
    return write_checkpoint(str(tmp_path_factory.mktemp('torch_export')))


def _stacks(h, w=None, seed=0, batch=1):
    rng = np.random.RandomState(seed)
    return [rng.rand(batch, 9, h, w or h, 3).astype('f4') for _ in range(4)]


def _np(out):
    return {k: v.cpu().numpy() for k, v in out.items()}


def _jax(ckpt, stacks, **kw):
    fwd, variables, _ = j_build_inference(ckpt, **kw)
    out = jax.jit(fwd)(variables, *stacks)
    return {k: np.asarray(v) for k, v in out.items()}


def test_export_round_trip_matches_direct(ckpt):
    blob = export_inference(ckpt, 64, 64)
    fn, meta = load_exported(blob, device='cpu')
    assert meta['height'] == 64 and meta['batch'] == 1
    assert meta['config']['model_uncert']
    # BatchNorm is folded into the convolutions
    assert meta['config']['model_no_batchnorm']

    stacks = _stacks(64)
    out = _np(fn(*stacks))
    assert sorted(out) == ['logvar', 'mean', 'posterior']

    model, _ = build_inference(ckpt)
    ref = _np(inference_fn(model, meta)(*stacks))
    for k in ref:
        np.testing.assert_array_equal(out[k], ref[k], err_msg=k)


def test_export_matches_jax(ckpt):
    fn, _ = load_exported(export_inference(ckpt, 48, 40), device='cpu')
    stacks = _stacks(48, 40, seed=1)
    got = _np(fn(*stacks))
    want = _jax(ckpt, stacks)
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_allclose(got[k], want[k], atol=ATOL, err_msg=k)


def _check_ensemble(got, want):
    """The tolerances of tests/test_torch_ensemble.py."""
    for key in ('means', 'logvars'):
        if key in want:
            np.testing.assert_allclose(got[key], want[key], atol=5e-4,
                                       err_msg=key)
    # near-ties between members may flip under reordered float sums:
    # compare the selection by agreement share, not bitwise
    agree = np.isclose(got['mean'], want['mean'], atol=5e-4)
    assert agree.mean() >= 0.999, agree.mean()
    np.testing.assert_allclose(got['logvar'], want['logvar'], atol=5e-4)
    np.testing.assert_allclose(got['posterior'], want['posterior'],
                               atol=1e-4)


@pytest.mark.parametrize('members', [False, True])
def test_export_ensemble_matches_jax(ckpt, members):
    fn, meta = load_exported(export_inference(ckpt, 32, 32, members=members,
                                              **ESE), device='cpu')
    assert meta['val_ensamble'] and meta['calibration'] is None
    stacks = _stacks(32, seed=2)
    got = _np(fn(*stacks))
    assert got['posterior'].shape == (1, 32, 32, 7)
    assert ('means' in got) == members
    if members:
        assert got['means'].shape == (7, 1, 32, 32)
    want = _jax(ckpt, stacks, members=members, **ESE)
    assert sorted(got) == sorted(want)
    _check_ensemble(got, want)


def test_export_with_calibration_matches_jax(ckpt):
    """Scores land in the meta; the offsets are baked into the ensemble,
    against the JAX program with the same offsets, and a constant offset
    keeps the selection and lowers the logvar by exactly itself."""
    offsets = np.random.RandomState(4).uniform(-1, 1, 7).tolist()
    cal = {'rank_corr': 0.81, 'bare_mse': 0.1, 'ese_mse': 0.05,
           'calibrated': True, 'member_offsets': offsets}
    fn, meta = load_exported(export_inference(ckpt, 32, 32, calibration=cal,
                                              **ESE), device='cpu')
    assert meta['calibration']['recalibrated'] is True
    assert meta['calibration']['rank_corr'] == pytest.approx(0.81)
    assert meta['member_offsets'] == offsets
    stacks = _stacks(32, seed=3)
    _check_ensemble(_np(fn(*stacks)),
                    _jax(ckpt, stacks, calibration=cal, **ESE))

    fn1, _ = load_exported(export_inference(
        ckpt, 32, 32, calibration=dict(cal, member_offsets=[1.0] * 7),
        **ESE), device='cpu')
    fn0, meta0 = load_exported(export_inference(ckpt, 32, 32, **ESE),
                               device='cpu')
    assert meta0['calibration'] is None
    out1, out0 = _np(fn1(*stacks)), _np(fn0(*stacks))
    np.testing.assert_array_equal(out1['mean'], out0['mean'])
    np.testing.assert_allclose(out1['logvar'], out0['logvar'] - 1.0,
                               atol=1e-6)


@pytest.mark.parametrize('ese', [False, True], ids=['upr', 'ese'])
def test_export_u8_matches_host_path_and_jax(ckpt, ese):
    """u8 ingest (uint8 stacks, /255 and the shift on the device) equals
    the fp32 artifact fed host-normalized, host-shifted views, and the JAX
    u8 artifact."""
    size, shift = (32, 1.25) if ese else (64, 0.75)
    kw = ESE if ese else {}
    rng = np.random.RandomState(3)
    u8 = [rng.randint(0, 256, (1, 9, size, size, 3), dtype=np.uint8)
          for _ in range(4)]
    fn_u8, meta = load_exported(export_inference(ckpt, size, size, u8=True,
                                                 **kw), device='cpu')
    assert meta['u8'] is True
    got = _np(fn_u8(*u8, shift))

    fn, _ = load_exported(export_inference(ckpt, size, size, **kw),
                          device='cpu')
    host = np_shift_lf(*[s[0].astype(np.float32) / 255.0 for s in u8],
                       shift)
    want = _np(fn(*[s[None] for s in host]))
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=1e-5, atol=1e-5,
                                   err_msg=k)

    j_fn, _ = j_load_exported(j_export_inference(
        ckpt, size, size, u8=True, platforms=('cpu',), **kw))
    j_out = {k: np.asarray(v)
             for k, v in j_fn(*u8, np.float32(shift)).items()}
    if ese:
        _check_ensemble(got, j_out)
    else:
        for k in j_out:
            np.testing.assert_allclose(got[k], j_out[k], atol=ATOL,
                                       err_msg=k)


def _jax_tiled(blob, stacks, tile, halo, shift=None):
    """The JAX tiled artifact on the true-size ``stacks``: padded to its
    canvas, with the tile-position table (as mmlf_tpu.serve does), then
    cropped back."""
    fn, _ = j_load_exported(blob)
    ht, wt = stacks[0].shape[2:4]
    smin = max(2, -(-(tile + 2 * halo) // tile)) * tile
    hc, wc = max(-(-ht // tile) * tile, smin), max(-(-wt // tile) * tile, smin)
    padded = [np.pad(s, ((0, 0), (0, 0), (0, hc - ht), (0, wc - wt),
                         (0, 0))) for s in stacks]
    pos = j_tile_positions(ht, wt, tile, halo,
                           pad_to=(hc // tile) * (wc // tile))
    extra = () if shift is None else (np.float32(shift),)
    out = fn(*padded, pos.astype(np.int32), *extra)
    return np.asarray(out['mean'])[:, :ht, :wt]


@pytest.mark.parametrize('shape', [(64, 64), (72, 56)])
def test_export_tiled_matches_whole_and_jax(ckpt, shape):
    """One tiled artifact serves scenes of any shape at least one window
    wide: UPR tiles exactly, so it equals the whole-scene forward, and it
    equals the JAX tiled artifact."""
    ht, wt = shape
    fn, meta = load_exported(export_inference(ckpt, 0, 0, tiled=16),
                             device='cpu')
    assert meta['tiled'] == 16 and meta['halo'] == 6
    assert 'height' not in meta
    stacks = [s[:, :, :ht, :wt] for s in _stacks(80, seed=5)]
    got = _np(fn(*stacks))
    assert got['mean'].shape == (1, ht, wt)

    model, whole_meta = build_inference(ckpt)
    whole = _np(inference_fn(model, whole_meta)(*stacks))
    for k in whole:
        np.testing.assert_allclose(got[k], whole[k], atol=1e-5, err_msg=k)

    j_blob = j_export_inference(ckpt, 0, 0, platforms=('cpu',), tiled=16)
    np.testing.assert_allclose(got['mean'],
                               _jax_tiled(j_blob, stacks, 16, 6),
                               atol=ATOL)

    with pytest.raises(ValueError, match='smaller than the tile window'):
        fn(*[s[:, :, :27] for s in stacks])


def test_export_tiled_u8_matches_jax_off_the_border(ckpt):
    """The u8 shift runs before the tiling in both packages, but the JAX
    artifact shifts its zero-padded canvas (the scene padded up to a tile
    multiple), so its views wrap the padding in where the port's wrap the
    scene's opposite edge.  The views differ only within the largest view
    shift (4 x |shift|, rounded up, plus 1 for the lerp) of the border,
    and the outputs within that plus the net's receptive radius (6): the
    comparison keeps clear of that band."""
    shift, (ht, wt) = 0.75, (72, 56)      # canvas 80 x 64: padded both ways
    rng = np.random.RandomState(6)
    u8 = [rng.randint(0, 256, (1, 9, ht, wt, 3), dtype=np.uint8)
          for _ in range(4)]
    fn, _ = load_exported(export_inference(ckpt, 0, 0, tiled=16, u8=True),
                          device='cpu')
    got = _np(fn(*u8, shift))['mean']
    want = _jax_tiled(j_export_inference(ckpt, 0, 0, platforms=('cpu',),
                                         tiled=16, u8=True),
                      u8, 16, 6, shift)
    m = int(np.ceil(4 * shift)) + 1 + 6
    np.testing.assert_allclose(got[:, m:-m, m:-m], want[:, m:-m, m:-m],
                               atol=ATOL)
    # the band is real: at the bottom/right border the two differ
    assert np.abs(got - want).max() > 1e-3


def test_export_guards(ckpt, tmp_path):
    with pytest.raises(ValueError, match='batch=1 only'):
        export_inference(ckpt, 0, 0, tiled=16, batch=2)
    with pytest.raises(ValueError, match='only apply to an ensemble'):
        export_inference(ckpt, 32, 32,
                         calibration={'member_offsets': [1.0] * 7})

    junk = str(tmp_path / 'junk.bin')
    with open(junk, 'wb') as f:
        f.write(b'not an artifact at all')
    with pytest.raises(ValueError, match='not an mmlf_tpu_torch export'):
        load_exported(junk, device='cpu')
    j_blob = j_export_inference(ckpt, 32, 32, platforms=('cpu',))
    with pytest.raises(ValueError, match='JAX StableHLO artifact; serve '
                                         'the run directory'):
        load_exported(j_blob, device='cpu')
    blob = export_inference(ckpt, 32, 32)
    with pytest.raises(ValueError, match='does not match its header'):
        load_exported(blob[:-1], device='cpu')

    fn, _ = load_exported(blob, device='cpu')
    with pytest.raises(ValueError, match='artifact takes stacks of shape'):
        fn(*_stacks(48))
    fn_u8, _ = load_exported(export_inference(ckpt, 32, 32, u8=True),
                             device='cpu')
    with pytest.raises(TypeError, match='uint8 stacks'):
        fn_u8(*_stacks(32), 0.0)


def test_invertible_checkpoint_export_raises(tmp_path):
    """A checkpoint that stores --model_invertible (the reference's INN)
    is refused by ``export_inference``."""
    path = write_checkpoint(str(tmp_path))
    state = torch.load(os.path.join(path, 'checkpoint.pt'),
                       weights_only=False)
    state['hyper_parameters']['model_invertible'] = True
    torch.save(state, os.path.join(path, 'checkpoint.pt'))
    with pytest.raises(NotImplementedError,
                       match='INNs are not supported anymore'):
        export_inference(path, 32, 32)


def test_inn_run_exports_like_jax(tmp_path):
    """A JAX-initialised --model_inn run directory exported by both
    packages: the port's fp32 artifact's outputs equal mmlf_tpu.export's
    (1e-5)."""
    import jax.numpy as jnp
    from mmlf_tpu.models.inn import INN as JINN
    from mmlf_tpu.train import checkpoint as jckpt
    jcfg = JConfig(model_views=9, model_in_blocks=1, model_out_blocks=1,
                   model_inn=True).finalize()
    stacks = _stacks(32, seed=3)
    variables = jax.jit(JINN.from_config(jcfg).init)(
        jax.random.PRNGKey(5), *map(jnp.asarray, stacks))
    path = str(tmp_path / 'inn')
    os.makedirs(path)
    jckpt.save_checkpoint(path, jax.device_get(dict(variables)),
                          jcfg.to_dict(), 0, 0, 0.0)
    fn, meta = load_exported(export_inference(path, 32, 32), device='cpu')
    assert meta['config']['model_inn'] and meta['dtype'] == 'float32'
    j_fn, _ = j_load_exported(j_export_inference(path, 32, 32,
                                                 platforms=('cpu',)))
    got = fn(*map(torch.from_numpy, stacks))
    want = j_fn(*stacks)
    for k in ('mean', 'logvar', 'posterior', 'zixels', 'jac'):
        np.testing.assert_allclose(got[k].numpy(), np.asarray(want[k]),
                                   rtol=1e-5, atol=1e-5, err_msg=k)


def test_export_cli(ckpt, tmp_path):
    from click.testing import CliRunner
    path = str(tmp_path / 'cli.mmlft')
    res = CliRunner().invoke(main, [ckpt, path, '--height', '32',
                                    '--width', '32', '--val_ensamble',
                                    '--val_disp_step', '1.0', '--u8'])
    assert res.exit_code == 0, res.output
    fn, meta = load_exported(path, device='cpu')
    assert meta['u8'] and meta['val_ensamble'] and meta['height'] == 32
    u8 = [np.zeros((1, 9, 32, 32, 3), np.uint8)] * 4
    assert np.isfinite(fn(*u8, 0.0)['mean'].numpy()).all()

    res = CliRunner().invoke(main, [ckpt, path, '--tiled', '16',
                                    '--batch', '2'])
    assert res.exit_code != 0 and 'batch=1 only' in res.output
