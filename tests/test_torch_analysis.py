"""The port's analysis suite against mmlf_tpu's: every CLI of both packages
on copies of the same artifacts tree, every written file and the printed
text equal; the numpy functions equal on seeded inputs; gmm_cnt's density
against the JAX scan and its mode maps; the plot renderer."""

import os
import shutil

import numpy as np
import pytest
from click.testing import CliRunner

import jax.numpy as jnp
import torch

from mmlf_tpu.utils import gmm_cnt as JGC
from mmlf_tpu.utils import modecnt as JMC
from mmlf_tpu.utils import nll2csv as JNLL
from mmlf_tpu.validate import cluster as JC
from mmlf_tpu.validate import sparsify as JS
from mmlf_tpu_torch.utils import gmm_cnt as GC
from mmlf_tpu_torch.utils import modecnt as MC
from mmlf_tpu_torch.utils import nll2csv as NLL
from mmlf_tpu_torch.utils import pfm
from mmlf_tpu_torch.utils.imgio import save_img
from mmlf_tpu_torch.validate import cluster as C
from mmlf_tpu_torch.validate import sparsify as S

SMALL = dict(model_chs=8, model_views=9, model_in_blocks=1,
             model_out_blocks=2, model_uncert=True)


def _synthetic_tree(root):
    """The artifacts tree of tests/test_analysis_cli.py (48², one scene,
    4 mixture members), with a dataset beside it for ``edges``."""
    rng = np.random.default_rng(0)
    scene = os.path.join(root, 'scenes', 'toy')
    os.makedirs(scene)
    h = w = 48
    gt = rng.normal(0, 1, (h, w)).astype(np.float32)
    result = gt + rng.normal(0, 0.1, (h, w)).astype(np.float32)
    uncert = np.abs(result - gt) + 0.01 * rng.random((h, w),
                                                     dtype=np.float32)
    pfm.save(os.path.join(scene, 'gt.pfm'), np.flip(gt, 0).copy())
    pfm.save(os.path.join(scene, 'result.pfm'), np.flip(result, 0).copy())
    pfm.save(os.path.join(scene, 'uncert.pfm'), np.flip(uncert, 0).copy())
    save_img(os.path.join(scene, 'center.png'),
             rng.random((h, w, 3), dtype=np.float32))
    post = rng.random((108, h, w), dtype=np.float32) * 0.05
    idx = np.clip(((gt + 3.5) / 7.0 * 107).astype(int), 0, 107)
    post[idx, np.arange(h)[:, None], np.arange(w)[None, :]] = 1.0
    np.save(os.path.join(scene, 'posterior.npy'), post)
    gmm = np.stack([rng.normal(0, 1, (4, h, w)),
                    rng.uniform(0.1, 0.5, (4, h, w))]).astype(np.float32)
    np.save(os.path.join(scene, 'gmm.npy'), gmm)
    ds = os.path.join(root, 'dataset', 'toy')
    os.makedirs(ds)
    pfm.save(os.path.join(ds, 'gt_disp_lowres.pfm'), np.flip(gt, 0).copy())
    return scene


def _validated_tree(root):
    """A tree written by the port's own validate CLI (ESE, 70 members) on a
    64² synthetic scene from a tiny seeded checkpoint, on the CPU; the
    dataset is kept beside it for ``edges``."""
    from mmlf_tpu_torch.config import Config
    from mmlf_tpu_torch.data.synth import generate_dataset
    from mmlf_tpu_torch.models.feed_forward import FeedForward, init_live_
    from mmlf_tpu_torch.utils.convert import save_checkpoint_pt
    from mmlf_tpu_torch.validate.cli import main

    ds = os.path.join(root, 'dataset')
    generate_dataset(ds, scenes=1, size=64, seed=5)
    cfg = Config(**SMALL).finalize()
    model = init_live_(FeedForward.from_config(cfg), seed=11)
    save_checkpoint_pt(os.path.join(root, 'checkpoint.pt'),
                       model.state_dict(), cfg)
    res = CliRunner().invoke(main, [root, ds, '--val_ensamble', '--device',
                                    'cpu'])
    assert res.exit_code == 0, res.output
    return os.path.join(root, 'scenes', 'scene_00')


GMM_CNT_STEP = 0.05
# (name, module under mmlf_tpu(_torch), arguments from (root, scene), the
# np.random seed for --random, extra arguments of the port).  gmm_cnt runs
# at step 0.05 (fewer near ties than its default 0.005: the test's rule
# for them below, test_count_modes_* for the default step).
STEPS = [
    ('sparsify', 'validate.sparsify', lambda r, s: [r, '--step', '0.1']),
    ('sparsify_badpix', 'validate.sparsify',
     lambda r, s: [r, '--step', '0.05', '--badpix']),
    ('sparsify_random', 'validate.sparsify', lambda r, s: [r, '--random'],
     3),
    ('cluster', 'validate.cluster', lambda r, s: [r]),
    ('modecnt', 'utils.modecnt', lambda r, s: [r]),
    ('multimodal_uni', 'validate.multimodal', lambda r, s: [r, '--uni']),
    ('multimodal', 'validate.multimodal', lambda r, s: [r]),
    ('multimodal_lb', 'validate.multimodal', lambda r, s: [r, '--lb']),
    ('mm_prediction', 'validate.mm_prediction',
     lambda r, s: [r, '--step', '0.2', '--save_images']),
    ('mm_prediction_random', 'validate.mm_prediction',
     lambda r, s: [r, '--random'], 5),
    ('gmm_cnt', 'utils.gmm_cnt',
     lambda r, s: [s, s, '--step', str(GMM_CNT_STEP)], None,
     ['--device', 'cpu']),
    ('gmm2csv', 'utils.gmm2csv',
     lambda r, s: [os.path.join(s, 'gmm.npy'),
                   os.path.join(r, 'exports', 'gmm.csv'), '5', '6']),
    ('gmm2csv_sum', 'utils.gmm2csv',
     lambda r, s: [os.path.join(s, 'gmm.npy'),
                   os.path.join(r, 'exports', 'gmm_sum.csv'), '7', '3',
                   '--sum_only', '--step', '0.01']),
    ('gmm2csv2', 'utils.gmm2csv2',
     lambda r, s: [os.path.join(r, 'exports', 'demo.csv')]),
    ('nll2csv', 'utils.nll2csv',
     lambda r, s: [os.path.join(r, 'exports', 'nll.npy'),
                   os.path.join(r, 'exports', 'nll.csv'), '5', '6']),
    ('post2csv', 'utils.post2csv', lambda r, s: [s, '5', '6']),
    ('uncert2csv', 'utils.uncert2csv',
     lambda r, s: [os.path.join(s, 'result.pfm'),
                   os.path.join(s, 'uncert.pfm'),
                   os.path.join(r, 'exports', 'u.csv'), '5', '6']),
    ('edges', 'validate.edges', lambda r, s: [os.path.join(r, 'dataset')]),
]
STEPS = [st + (None,) * (5 - len(st)) for st in STEPS]
TREES = {'synthetic': _synthetic_tree, 'validated': _validated_tree}


def _snapshot(root):
    files = {}
    for d, _, names in os.walk(root):
        for n in names:
            p = os.path.join(d, n)
            with open(p, 'rb') as fh:
                files[os.path.relpath(p, root)] = fh.read()
    return files


def _run_chain(base, pkg):
    """Copy ``base`` and run every step of STEPS there with ``pkg``'s CLIs
    (cwd at the copy's root: multimodal writes its PNGs there); returns
    {step: (exit code, output with the root replaced, files the step
    wrote or changed, exception)} and, under 'maps', the mode maps that
    gmm_cnt's CLI computed."""
    import importlib
    root = f'{base}_{pkg}'
    shutil.copytree(base, root)
    scene = os.path.join(root, open(os.path.join(base, '.scene')).read())
    out = {}
    cwd = os.getcwd()
    gmm_cnt = importlib.import_module(f'{pkg}.utils.gmm_cnt')
    count_modes = gmm_cnt.count_modes

    def recording(*a, **kw):
        out['maps'] = count_modes(*a, **kw)
        return out['maps']

    gmm_cnt.count_modes = recording
    os.chdir(root)
    try:
        for name, mod, args, seed, extra in STEPS:
            main = importlib.import_module(f'{pkg}.{mod}').main
            argv = args(root, scene) + \
                (extra if pkg == 'mmlf_tpu_torch' and extra else [])
            before = _snapshot(root)
            if seed is not None:
                np.random.seed(seed)
            res = CliRunner().invoke(main, argv)
            after = _snapshot(root)
            wrote = {k: v for k, v in after.items() if before.get(k) != v}
            out[name] = (res.exit_code, res.output.replace(root, '<root>'),
                         wrote, res.exception)
    finally:
        os.chdir(cwd)
        gmm_cnt.count_modes = count_modes
    return out


@pytest.fixture(scope='module', params=list(TREES))
def chains(request, tmp_path_factory):
    base = str(tmp_path_factory.mktemp(f'analysis_{request.param}') / 'tree')
    os.makedirs(base)
    scene = TREES[request.param](base)
    with open(os.path.join(base, '.scene'), 'w') as fh:
        fh.write(os.path.relpath(scene, base))
    os.makedirs(os.path.join(base, 'exports'))
    np.save(os.path.join(base, 'exports', 'nll.npy'),
            np.random.default_rng(1).random((108, 48, 48), dtype=np.float32))
    runs = {pkg: _run_chain(base, pkg) for pkg in ('mmlf_tpu',
                                                   'mmlf_tpu_torch')}
    return base, scene, runs


@pytest.mark.parametrize('step', [s[0] for s in STEPS])
def test_cli_writes_what_jax_writes(chains, step, tmp_path, monkeypatch):
    """The step's exit code, printed text and every file it wrote or
    changed (CSV text, .npy, .pfm, PNG bytes, second_chance.txt) equal
    the JAX package's, byte for byte.

    gmm_cnt: the mode maps its CLI computed part from the JAX CLI's only
    at near ties (``_parted_only_at_ties``).  Where the maps are equal,
    the files are; where they part, the JAX CLI given the port's maps
    writes the port's files byte for byte."""
    base, scene, runs = chains
    code, text, wrote, exc = runs['mmlf_tpu_torch'][step]
    jcode, jtext, jwrote, jexc = runs['mmlf_tpu'][step]
    assert jcode == 0, jexc
    assert code == 0, exc
    assert wrote, 'the step wrote nothing'
    assert sorted(wrote) == sorted(jwrote)
    if step == 'gmm_cnt':
        gmm = np.load(os.path.join(scene, 'gmm.npy'))
        maps = runs['mmlf_tpu_torch']['maps']
        if _parted_only_at_ties(gmm, GMM_CNT_STEP, maps,
                                runs['mmlf_tpu']['maps'])[0]:
            copy = str(tmp_path / 'scene')
            shutil.copytree(scene, copy)
            monkeypatch.setattr(JGC, 'count_modes', lambda *a, **kw: maps)
            res = CliRunner().invoke(JGC.main, [copy, copy, '--step',
                                                str(GMM_CNT_STEP)])
            assert res.exit_code == 0, res.exception
            jtext = res.output
            rel = os.path.relpath(scene, base)
            jwrote = {os.path.join(rel, n): open(os.path.join(copy, n),
                                                 'rb').read()
                      for n in os.listdir(copy)}
    for name in wrote:
        assert wrote[name] == jwrote[name], name
    assert text == jtext


# ------------------------------------------------------------- functions


def _gt_result_uncert(seed, n=700):
    rng = np.random.default_rng(seed)
    gt = rng.normal(size=n).astype(np.float32)
    result = gt + (rng.normal(size=n) * 0.1).astype(np.float32)
    uncert = np.abs(result - gt) + (rng.normal(size=n) * 0.02).astype(
        np.float32)
    return gt, result, uncert


@pytest.mark.parametrize('step,mse', [(0.1, True), (0.01, True),
                                      (0.05, False)])
def test_sparsification_curves_equal_jax(step, mse):
    gt, result, uncert = _gt_result_uncert(int(step * 100) + mse)
    want = JS.sparsification_curves(gt, result, uncert, step, mse)
    got = S.sparsification_curves(gt, result, uncert, step, mse)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    assert S.auc(got[2], step) == JS.auc(want[2], step)
    assert S.auc([0.0, 1.0, 0.0], 0.5) == JS.auc([0.0, 1.0, 0.0], 0.5)
    mask = uncert < np.median(uncert)
    for f in ('masked_mse', 'masked_l1', 'masked_badpix'):
        assert getattr(S, f)(result, gt, mask) == \
            getattr(JS, f)(result, gt, mask), f


@pytest.mark.parametrize('k', [2, 3])
def test_kmeans_and_cluster_modes_equal_jax(k):
    rng = np.random.default_rng(k)
    samples = np.concatenate([rng.normal(-2.0, 0.3, (40, 6)),
                              rng.normal(3.0, 0.4, (40, 7))], axis=1)
    np.testing.assert_array_equal(C.kmeans_1d(samples, k),
                                  JC.kmeans_1d(samples, k))
    gt = rng.normal(0, 0.2, (32, 32)).astype(np.float32)
    gt[:, 16:] += 2.0
    gt[20:, :] -= 1.5
    for radius in (1.0, 2.0, 2.5):
        np.testing.assert_array_equal(C.cluster_modes(gt, radius, k),
                                      JC.cluster_modes(gt, radius, k))
    np.testing.assert_array_equal(C.disc_offsets(2.5), JC.disc_offsets(2.5))


@pytest.mark.parametrize('outlier', [0.1, 0.5])
def test_mode_analysis_equals_jax(outlier):
    from scipy.ndimage import gaussian_filter1d
    rng = np.random.default_rng(2)
    post = rng.random((60, 12, 10)).astype(np.float32) * 0.1
    post[rng.integers(0, 60, 120), rng.integers(0, 12, 120),
         rng.integers(0, 10, 120)] = 1.0
    post = gaussian_filter1d(post, sigma=2, axis=0)
    for g, w in zip(MC.mode_analysis(post, outlier),
                    JMC.mode_analysis(post, outlier)):
        np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize('batched', [False, True])
def test_pixel_likelihood_rows_equal_jax(batched):
    nll = np.random.default_rng(3).random((108, 8, 8)).astype(np.float32)
    nll = nll[None] * 5 if batched else nll * 5
    for start, stop in ((-3.5, 3.5), (-2.0, 1.5)):
        got = NLL.pixel_likelihood_rows(nll, 3, 2, start, stop)
        want = JNLL.pixel_likelihood_rows(nll, 3, 2, start, stop)
        for g, w in zip(got, want):
            assert g.dtype == w.dtype
            np.testing.assert_array_equal(g, w)


def test_second_chance_equals_jax():
    rng = np.random.default_rng(4)
    gt, result = rng.normal(size=(2, 20, 20)).astype(np.float32)
    lo, hi = np.sort(rng.normal(size=(2, 20, 20)).astype(np.float32), 0)
    lo[0, :5] = hi[0, :5] = gt[0, :5]           # ties of the two modes
    np.testing.assert_array_equal(GC.second_chance(result, gt, lo, hi),
                                  JGC.second_chance(result, gt, lo, hi))


def test_read_csv_degenerate_shapes(tmp_path):
    """One data row parses as one row; an x-only file is refused with the
    JAX package's message; a ragged file too."""
    import click
    from mmlf_tpu.visualize.plot import read_csv as jread_csv
    from mmlf_tpu_torch.visualize.plot import read_csv

    row = tmp_path / 'row.csv'
    row.write_text('x, a, b\n1.0, 2.0, 3.0\n')
    col = tmp_path / 'col.csv'
    col.write_text('x, a\n1.0, 2.0\n3.0, 4.0\n5.0, 6.0\n')
    for p in (row, col):
        (names, data), (jnames, jdata) = read_csv(str(p)), jread_csv(str(p))
        assert names == jnames
        np.testing.assert_array_equal(data, jdata)
    assert data.shape == (3, 2)
    assert read_csv(str(row))[1].shape == (1, 3)
    xonly = tmp_path / 'xonly.csv'
    xonly.write_text('x\n1.0\n2.0\n')
    ragged = tmp_path / 'ragged.csv'
    ragged.write_text('x, a, b\n1.0, 2.0\n3.0, 4.0\n')
    for p, match in ((xonly, 'nothing to plot'), (ragged, 'header')):
        with pytest.raises(click.ClickException, match=match) as got:
            read_csv(str(p))
        with pytest.raises(click.ClickException) as want:
            jread_csv(str(p))
        assert got.value.message == want.value.message


# --------------------------------------------------------------- gmm_cnt


def _gmm(seed, k, h, w):
    rng = np.random.default_rng(seed)
    return np.stack([rng.normal(0, 1, (k, h, w)),
                     rng.uniform(0.1, 0.5, (k, h, w))]).astype(np.float32)


def _parted_only_at_ties(gmm, step, got, want, rel=1e-5):
    """Hold the port's maps ``got`` against the JAX package's ``want`` on
    the grid of ``step``: every local-maximum decision (d[g] against
    d[g-1] and d[g+1]) that the port's float32 density takes otherwise
    than the JAX scan's is a near tie, two values within ``rel`` of each
    other in float64; and the maps equal at every pixel without a near
    tie.  (Not "without a flip": torch's float32 exp on the CPU is not
    bitwise reproducible from one call to the next, so the densities of
    ``got`` need not be the ones recomputed here.)  Returns the shares of
    pixels where the maps part and where a decision is a near tie."""
    grid = np.arange(-3.5, 3.5, step, dtype=np.float32)
    k = gmm.shape[1]
    m, v = (gmm[i].reshape(k, -1) for i in (0, 1))
    jd = np.asarray(JGC._mixture_on_grid(jnp.asarray(m), jnp.asarray(v),
                                         jnp.asarray(grid)))
    jmax = np.zeros(jd.shape, bool)
    jmax[1:-1] = (jd[1:-1] > jd[:-2]) & (jd[1:-1] > jd[2:])
    flips = jmax != GC.local_maxima(GC.mixture_on_grid(
        torch.from_numpy(m), torch.from_numpy(v),
        torch.from_numpy(grid))).numpy()
    x = grid.astype(np.float64)[:, None]
    d = sum(1.0 / np.sqrt(2.0 * np.pi * vv) *
            np.exp(-(x - mm) ** 2 / (2.0 * vv)) / vv
            for mm, vv in zip(m.astype(np.float64), v.astype(np.float64)))
    close = np.abs(np.diff(d, axis=0)) <= rel * np.maximum(d[1:], d[:-1])
    ties = np.zeros(d.shape, bool)
    ties[1:-1] = close[:-1] | close[1:]
    assert not (flips & ~ties).any()
    differ = np.zeros(gmm.shape[2:], bool)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and g.shape == w.shape
        differ |= g != w
    tied = ties.any(0).reshape(differ.shape)
    assert not (differ & ~tied).any()
    return differ.mean(), tied.mean()


@pytest.mark.parametrize('k', [1, 4, 9])
def test_mixture_on_grid_matches_jax_scan(k):
    """The port's density against ``_mixture_on_grid`` (the jitted scan) on
    the CPU: rtol 1e-5 (measured ~4e-7: XLA's and torch's exp and
    reciprocal square root part by an ulp or two).  A lone member's far
    tail underflows: XLA on the CPU flushes a denormal exponential to zero
    and torch keeps it, so atol is the largest such term, the smallest
    normal float32 times max 1/(sqrt(2πv)·v)."""
    gmm = _gmm(k, k, 16, 24)
    grid = np.arange(-3.5, 3.5, 0.005, dtype=np.float32)
    m, v = (gmm[i].reshape(k, -1) for i in (0, 1))
    want = np.asarray(JGC._mixture_on_grid(jnp.asarray(m), jnp.asarray(v),
                                           jnp.asarray(grid)))
    got = GC.mixture_on_grid(torch.from_numpy(m), torch.from_numpy(v),
                             torch.from_numpy(grid))
    assert got.dtype == torch.float32 and got.shape == want.shape
    vmin = float(v.min())
    atol = np.finfo(np.float32).tiny / (np.sqrt(2.0 * np.pi * vmin) * vmin)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=atol)


@pytest.mark.parametrize('chunk', [8192, 100])
def test_count_modes_equal_jax_at_step_005(chunk):
    """At step 0.05 on narrow mixtures the counts and both mode maps equal
    the JAX package's at every pixel without a near tie, at least 98% of
    them (``_parted_only_at_ties``); chunks that do not divide the pixels
    too."""
    gmm = _gmm(0, 4, 48, 48)
    want = JGC.count_modes(gmm, -3.5, 3.5, 0.05)
    got = GC.count_modes(gmm, -3.5, 3.5, 0.05, chunk=chunk, device='cpu')
    assert _parted_only_at_ties(gmm, 0.05, got, want)[1] <= 0.02
    assert (got[0] > 0).all()


@pytest.mark.parametrize('variances', [(0.1, 0.5), (0.5, 1.6)])
def test_count_modes_parts_only_at_ties_at_default_step(variances):
    """At the default step 0.005 a mode's flat top puts neighbouring grid
    values within rounding of each other, the more so the broader the
    members (the second case spans the variances of a validate run's
    ESE members): the maps part from the JAX package's only at pixels
    whose flipped decisions are all near ties."""
    rng = np.random.default_rng(1)
    gmm = np.stack([rng.normal(0, 1, (8, 24, 24)),
                    rng.uniform(*variances, (8, 24, 24))]).astype(np.float32)
    want = JGC.count_modes(gmm, -3.5, 3.5, 0.005)
    got = GC.count_modes(gmm, -3.5, 3.5, 0.005, device='cpu')
    assert _parted_only_at_ties(gmm, 0.005, got, want)[0] < 0.5


# ------------------------------------------------------------------ plot


def test_plot_renders_as_jax_does(tmp_path):
    """The TeX-free renderer of both packages on the same sparsify.csv and
    distribution-curve CSV: both write the file, of sizes within 10%."""
    pytest.importorskip('matplotlib')
    from mmlf_tpu.visualize.plot import main as jplot
    from mmlf_tpu_torch.visualize.plot import main as plot

    gt, result, uncert = _gt_result_uncert(0)
    fr, oracle, unc = S.sparsification_curves(gt, result, uncert, 0.1)
    csv = tmp_path / 'sparsify.csv'
    csv.write_text('frac,     oracle,     uncert, sparse_err\n' + ''.join(
        f'{a:.2f}, {b:.8f}, {c:.8f}, {c - b:.8f}\n'
        for a, b, c in zip(fr[:-1], oracle[1:], unc[1:])))
    curve = tmp_path / 'curve.csv'
    xs = np.arange(-3.5, 3.5, 0.05)
    curve.write_text('x, p\n' + ''.join(f'{x}, {np.exp(-x * x)}\n'
                                        for x in xs))
    for src, ext, extra in ((csv, 'png', []),
                            (curve, 'svg', ['--title', 'pixel (5,6)'])):
        sizes = []
        for name, cli in (('jax', jplot), ('torch', plot)):
            out = tmp_path / f'{src.stem}_{name}.{ext}'
            res = CliRunner().invoke(cli, [str(src), str(out), *extra])
            assert res.exit_code == 0, res.output
            sizes.append(out.stat().st_size)
        assert min(sizes) > 4000
        assert abs(sizes[0] - sizes[1]) <= 0.1 * sizes[0]
