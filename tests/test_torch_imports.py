"""The port stands alone: mmlf_tpu_torch imports neither JAX nor any module
of mmlf_tpu, builds nothing at import, and its entry points run on CUDA by
default and raise where CUDA is absent."""

import os
import re
import subprocess
import sys

import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG = os.path.join(REPO, 'mmlf_tpu_torch')

_PROBE = r'''
import importlib, pkgutil, sys
import mmlf_tpu_torch
names = [m.name for m in pkgutil.walk_packages(mmlf_tpu_torch.__path__,
                                               'mmlf_tpu_torch.')]
assert {'mmlf_tpu_torch.validate.tiling', 'mmlf_tpu_torch.export',
        'mmlf_tpu_torch.serve', 'mmlf_tpu_torch.utils.msgpack',
        'mmlf_tpu_torch.native', 'mmlf_tpu_torch.models.unet',
        'mmlf_tpu_torch.data.transforms', 'mmlf_tpu_torch.parallel.mesh',
        'mmlf_tpu_torch.probes.block_probe',
        'mmlf_tpu_torch.probes.gather_probe', 'mmlf_tpu_torch.models.inn',
        'mmlf_tpu_torch.models.invertible',
        'mmlf_tpu_torch.validate.spatial',
        'mmlf_tpu_torch.validate.sparsify', 'mmlf_tpu_torch.validate.cluster',
        'mmlf_tpu_torch.validate.edges', 'mmlf_tpu_torch.validate.multimodal',
        'mmlf_tpu_torch.validate.mm_prediction',
        'mmlf_tpu_torch.utils.modecnt', 'mmlf_tpu_torch.utils.gmm_cnt',
        'mmlf_tpu_torch.utils.gmm2csv', 'mmlf_tpu_torch.utils.gmm2csv2',
        'mmlf_tpu_torch.utils.nll2csv', 'mmlf_tpu_torch.utils.post2csv',
        'mmlf_tpu_torch.utils.uncert2csv', 'mmlf_tpu_torch.utils.dl',
        'mmlf_tpu_torch.visualize.plot'} <= set(names)
for name in names:
    importlib.import_module(name)
from mmlf_tpu_torch.ops.kernels import build
from mmlf_tpu_torch import native
bad = sorted(k for k in sys.modules
             if k in ('jax', 'flax', 'optax', 'msgpack', 'triton',
                      'mmlf_tpu', 'matplotlib')
             or k.startswith(('jax.', 'flax.', 'optax.', 'msgpack.',
                              'mmlf_tpu.', 'matplotlib.')))
assert not bad, bad
assert build.load.cache_info().currsize == 0, 'a kernel was loaded'
assert not native._Loaded.tried, 'the host library was loaded at import'
print(len(names))
'''


def test_port_imports_no_jax_or_mmlf_tpu():
    env = {k: v for k, v in os.environ.items() if k != 'PYTHONPATH'}
    proc = subprocess.run([sys.executable, '-c', _PROBE], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert int(proc.stdout.strip().splitlines()[-1]) >= 66


# an import of jax/flax/optax/msgpack/mmlf_tpu (not mmlf_tpu_torch), in
# statement or string form; docstrings may still name the JAX counterpart
# of a module
_FORBIDDEN = re.compile(
    r'^\s*(?:from|import)\s+(?:jax|flax|optax|msgpack|mmlf_tpu(?!_torch))\b'
    r'|import_module\(\s*[\'"](?:jax|flax|optax|msgpack|mmlf_tpu(?!_torch))'
    r'\b'
    r'|__import__\(\s*[\'"](?:jax|flax|optax|msgpack|mmlf_tpu(?!_torch))\b',
    re.MULTILINE)


def test_sources_have_no_forbidden_imports():
    scanned = 0
    for root, _, files in os.walk(PKG):
        for f in files:
            if f.endswith('.py'):
                with open(os.path.join(root, f)) as fh:
                    text = fh.read()
                assert not _FORBIDDEN.search(text), os.path.join(root, f)
                scanned += 1
    assert scanned >= 67
    for script in ('chip_smoke.py', 'k3_variants.py'):
        with open(os.path.join(REPO, script)) as fh:
            assert not _FORBIDDEN.search(fh.read()), script


def test_entry_points_raise_without_cuda(tmp_path):
    if torch.cuda.is_available():
        pytest.skip('this machine has CUDA; the test is for one without')
    from click.testing import CliRunner

    from mmlf_tpu_torch import serve
    from mmlf_tpu_torch.config import Config
    from mmlf_tpu_torch.export import load_exported
    from mmlf_tpu_torch.train import cli as train_cli
    from mmlf_tpu_torch.train.loop import train
    from mmlf_tpu_torch.validate.cli import main, run_validation
    with pytest.raises(RuntimeError, match='CUDA is not available'):
        run_validation(str(tmp_path), str(tmp_path), device='cuda')
    with pytest.raises(RuntimeError, match='CUDA is not available'):
        run_validation(str(tmp_path), str(tmp_path), val_ensamble=True,
                       val_tile=256, device='cuda')
    res = CliRunner().invoke(main, [str(tmp_path), str(tmp_path),
                                    '--val_ensamble'])
    assert isinstance(res.exception, RuntimeError), res.output
    for kw in ({'mesh_ensemble': 2}, {'mesh_space': 2}):
        with pytest.raises(RuntimeError, match='CUDA is not available'):
            run_validation(str(tmp_path), str(tmp_path), val_ensamble=True,
                           device='cuda', **kw)

    with pytest.raises(RuntimeError, match='CUDA is not available'):
        train(Config().finalize(), str(tmp_path))
    res = CliRunner().invoke(train_cli.main, [str(tmp_path),
                                              '--model_uncert'])
    assert isinstance(res.exception, RuntimeError), res.output
    assert 'CUDA is not available' in str(res.exception)

    with pytest.raises(RuntimeError, match='CUDA is not available'):
        serve.InferenceEngine(str(tmp_path))
    with pytest.raises(RuntimeError, match='CUDA is not available'):
        load_exported(b'MMLFPT01')
    res = CliRunner().invoke(serve.main, [str(tmp_path), '--no_warmup'])
    assert isinstance(res.exception, RuntimeError), res.output
    assert 'CUDA is not available' in str(res.exception)

    from mmlf_tpu_torch.probes import block_probe, gather_probe
    for fn in (block_probe.check, block_probe.bench,
               lambda: gather_probe.run('probe3')):
        with pytest.raises(RuntimeError, match='CUDA is not available'):
            fn()

    import numpy as np
    from mmlf_tpu_torch.utils import gmm_cnt
    gmm = np.ones((2, 3, 4, 4), np.float32)
    with pytest.raises(RuntimeError, match='CUDA is not available'):
        gmm_cnt.count_modes(gmm, -3.5, 3.5, 0.1)
    with pytest.raises(RuntimeError, match='CUDA is not available'):
        gmm_cnt.count_modes(gmm, -3.5, 3.5, 0.1, device='cuda')
    res = CliRunner().invoke(gmm_cnt.main, [str(tmp_path), str(tmp_path)])
    assert isinstance(res.exception, RuntimeError), res.output
    assert 'CUDA is not available' in str(res.exception)


def test_kernel_wrapper_takes_plain_version_only_on_cpu():
    from mmlf_tpu_torch.ops.kernels import posterior as K

    before = K.laplace_mixture_posterior.launches
    m = torch.zeros(2, 3)
    out = K.laplace_mixture_posterior(m, torch.ones(2, 3), torch.zeros(4))
    assert out.shape == (3, 4)
    assert K.laplace_mixture_posterior.launches == before
    with pytest.raises(ValueError, match='device'):
        K.laplace_mixture_posterior(m.to('meta'), torch.ones(2, 3,
                                                             device='meta'),
                                    torch.zeros(4, device='meta'))
    with pytest.raises(TypeError, match='float32'):
        K.laplace_mixture_posterior(m.double(), torch.ones(2, 3),
                                    torch.zeros(4))


def test_window_gather_takes_plain_version_only_on_cpu():
    from mmlf_tpu_torch.ops.kernels import window_gather as K

    before = K.window_gather.launches
    levels = [torch.arange(2 * 8 * 8 * 4, dtype=torch.float32).reshape(
        2, 8, 8, 4)]
    aux = [torch.zeros(2, 8, 8 * K.AUX_CH)]
    mpi = [torch.zeros(2, 8, 8 * K.MPI_CH)]
    idx = [1], [0], [2], [3]
    img, a, m = K.window_gather(levels, aux, mpi, *idx, win=4)
    assert img.shape == (1, 4, 4, 4) and m.shape == (1, 4, 4 * K.MPI_CH)
    assert torch.equal(img[0], levels[0][1, 2:6, 3:7])
    assert K.window_gather.launches == before
    assert K.window_gather(levels, aux, mpi, *idx, win=4,
                           with_mpi=False)[2] is None
    meta = [t.to('meta') for t in levels]
    with pytest.raises(ValueError, match='device'):
        K.window_gather(meta, [t.to('meta') for t in aux],
                        [t.to('meta') for t in mpi], *idx, win=4)


def test_train_cli_has_the_jax_flags():
    """Every flag of mmlf_tpu.train.cli but --jax_cache, with its default,
    plus --device (default cuda)."""
    jax_cli = os.path.join(REPO, 'mmlf_tpu', 'train', 'cli.py')
    with open(jax_cli) as fh:
        names = set(re.findall(r"@click\.option\('--([a-z0-9_]+)", fh.read()))
    from mmlf_tpu_torch.train.cli import main
    flags = {p.name: p.default for p in main.params}
    assert names - {'jax_cache'} <= set(flags)
    assert 'jax_cache' not in flags and flags['device'] == 'cuda'
    assert flags['train_accum'] == 1 and flags['val_interval'] == 100


def _jax_flags(*path):
    with open(os.path.join(REPO, 'mmlf_tpu', *path)) as fh:
        return set(re.findall(r"@click\.option\('--([a-z0-9_]+)", fh.read()))


def test_export_and_serve_clis_have_the_jax_flags():
    """The export CLI: every flag of mmlf_tpu.export but --platforms and
    --jax_cache (nothing is lowered or compiled), with its default.  The
    serve CLI: every flag of mmlf_tpu.serve but --jax_cache, plus --device
    (default cuda)."""
    from mmlf_tpu_torch import export, serve
    for cli, path, dropped in (
            (export.main, ('export.py',), {'platforms', 'jax_cache'}),
            (serve.main, ('serve.py',), {'jax_cache'})):
        names = _jax_flags(*path)
        flags = {p.name: p.default for p in cli.params}
        assert dropped <= names
        assert names - dropped <= set(flags), path
        assert not dropped & set(flags), path
    flags = {p.name: p.default for p in export.main.params}
    assert flags['height'] == 512 and flags['batch'] == 1 and \
        flags['tiled'] == 0 and flags['val_disp_step'] == 0.1
    flags = {p.name: p.default for p in serve.main.params}
    assert flags['device'] == 'cuda' and flags['port'] == 8417 and \
        flags['decode_threads'] == 8 and flags['host'] == '127.0.0.1'


def test_package_data_ships_every_source():
    """Every file under the port's csrc/, csrc_host/ and visualize/*/ (the
    kernel sources and headers, the host library's source, the TeX figure
    builds) matches a package-data glob of pyproject.toml."""
    import glob
    import tomllib
    with open(os.path.join(REPO, 'pyproject.toml'), 'rb') as fh:
        data = tomllib.load(fh)['tool']['setuptools']['package-data']
    shipped = set()
    for pkg, patterns in data.items():
        pkg_dir = os.path.join(REPO, *pkg.split('.'))
        for pattern in patterns:
            shipped.update(glob.glob(os.path.join(pkg_dir, pattern)))
    wanted = [p for sub in ('csrc/*', 'csrc_host/*', 'visualize/*/*')
              for p in glob.glob(os.path.join(PKG, sub))
              if os.path.isfile(p)]
    assert len(wanted) >= 9
    missing = sorted(os.path.relpath(p, REPO) for p in wanted
                     if p not in shipped)
    assert not missing, missing
