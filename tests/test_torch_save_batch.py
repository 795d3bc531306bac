"""The port's artifact writer (``HCI4D.save_batch``, files written on a pool
of threads, from a handed sample or a fresh load) writes the file tree of
mmlf_tpu's serial writer byte for byte, and a job's error reaches the
caller with no thread left behind."""

import os
import threading

import numpy as np
import pytest

from mmlf_tpu.data import HCI4D as JHCI4D
from mmlf_tpu_torch.data import transforms as T
from mmlf_tpu_torch.data.hci4d import HCI4D
from mmlf_tpu_torch.data.synth import generate_dataset

import torch_threads  # noqa: F401  torch's share of the CPUs under xdist

SIZE, MEMBERS, BINS = 32, 5, 12


@pytest.fixture(scope='module')
def dataset(tmp_path_factory):
    root = str(tmp_path_factory.mktemp('save_batch_data'))
    generate_dataset(root, scenes=2, size=SIZE, seed=3)
    return root


def _outputs():
    rng = np.random.default_rng(7)
    result = rng.normal(0.0, 1.0, (1, SIZE, SIZE)).astype(np.float32)
    uncert = rng.normal(-1.0, 0.5, (1, SIZE, SIZE)).astype(np.float32)
    gmm = rng.random((2, MEMBERS, 1, SIZE, SIZE), np.float32)
    nll = rng.random((1, BINS, SIZE, SIZE), np.float32)
    # channels last on the card, permuted bin-first as run_validation does
    posterior = rng.random((1, SIZE, SIZE, BINS),
                           np.float32).transpose(0, 3, 1, 2)
    assert not posterior[0].flags.c_contiguous
    return result, uncert, 0.25, gmm, nll, posterior


def _tree(root):
    tree = {}
    for d, _, files in os.walk(root):
        for f in files:
            with open(os.path.join(d, f), 'rb') as fh:
                tree[os.path.relpath(os.path.join(d, f), root)] = fh.read()
    return tree


@pytest.mark.parametrize('handed', [True, False])
def test_save_batch_matches_jax_bytes(handed, dataset, tmp_path):
    shift = T.Shift(0.5)
    ds, jds = HCI4D(dataset, transform=shift), JHCI4D(dataset,
                                                      transform=shift)
    want, got = str(tmp_path / 'jax'), str(tmp_path / 'torch')
    outputs = _outputs()
    jds.save_batch(want, np.array([[1]]), *outputs)
    sample = ds[1] if handed else None
    ds.save_batch(got, np.array([[1]]), *outputs, sample=sample)

    want_tree, got_tree = _tree(want), _tree(got)
    assert sorted(got_tree) == sorted(want_tree)
    # views, the other PNGs, the PFMs, the npys, the submission's two
    assert len(got_tree) == 36 + 5 + 3 + 3 + 2
    for name, data in want_tree.items():
        assert got_tree[name] == data, name


def test_save_batch_raises_a_job_error_and_joins(dataset, tmp_path):
    ds = HCI4D(dataset)
    out = str(tmp_path / 'out')
    # a directory where the first view's PNG goes
    blocked = os.path.join(out, 'scenes', ds.scenes_names[0], 'view_h_0.png')
    os.makedirs(blocked)
    threads = threading.active_count()
    with pytest.raises(IsADirectoryError, match='view_h_0.png'):
        ds.save_batch(out, np.array([[0]]), *_outputs(), sample=ds[0])
    assert threading.active_count() == threads
    # the other jobs ran to their end
    assert os.path.getsize(os.path.join(os.path.dirname(blocked),
                                        'posterior.npy')) > 0
