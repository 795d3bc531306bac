"""The port's asynchronous ModelSaver against mmlf_tpu's: supersession of an
unwritten save, the drain on close(), best-only mode and a write error
raised at the next save; the snapshot taken at the call (an in-place
optimizer step after it does not reach the file); and the train loop's
drain, which never replaces an exception already on its way up."""

import os
import threading
import time

import numpy as np
import pytest
import torch

from mmlf_tpu.train import checkpoint as jckpt
from mmlf_tpu_torch.config import Config
from mmlf_tpu_torch.train import checkpoint as ckpt

import torch_threads  # noqa: F401  torch's share of the CPUs under xdist

WAIT = 30


def _port_save(saver, out, i, loss=0.0):
    model = torch.nn.Linear(3, 2)
    return saver(out, model, torch.optim.Adam(model.parameters()),
                 Config(), 0, i, loss)


def _jax_save(saver, out, i, loss=0.0):
    return saver(out, {'w': np.full(3, float(i), np.float32)}, {'h': 1}, 0,
                 i, loss)


# per package: its checkpoint module, a save of iteration i, and the
# iteration of a write job as its _write_checkpoint receives it
PACKAGES = {
    'jax': (jckpt, _jax_save,
            lambda job: int(job[1]['__meta__']['iteration'])),
    'torch': (ckpt, _port_save, lambda job: int(job[1]['iteration'])),
}


def _recording_writer(monkeypatch, mod, iteration_of, gate=None,
                      fail=False):
    """Replace ``mod._write_checkpoint``: record each job's iteration,
    optionally wait for ``gate`` first, optionally fail."""
    log = {'written': [], 'started': threading.Event()}

    def write(*job):
        log['started'].set()
        if gate is not None:
            assert gate.wait(WAIT)
        if fail:
            raise OSError('disk full')
        log['written'].append(iteration_of(job))

    monkeypatch.setattr(mod, '_write_checkpoint', write)
    return log


def _supersede(pkg, monkeypatch, tmp_path):
    mod, save, iteration_of = PACKAGES[pkg]
    gate = threading.Event()
    log = _recording_writer(monkeypatch, mod, iteration_of, gate=gate)
    saver = mod.ModelSaver()
    save(saver, str(tmp_path), 0)
    assert log['started'].wait(WAIT)      # the writer holds job 0
    for i in (1, 2, 3):
        save(saver, str(tmp_path), i)
    gate.set()
    saver.close()
    assert not saver._thread.is_alive()
    return log['written']


def test_newer_save_supersedes_unwritten_one(monkeypatch, tmp_path):
    """While the writer holds save 0, saves 1-3 arrive: 1 and 2 are never
    written, 3 is, and close() waits for it."""
    got = _supersede('torch', monkeypatch, tmp_path / 'torch')
    want = _supersede('jax', monkeypatch, tmp_path / 'jax')
    assert got == want == [0, 3]


@pytest.mark.parametrize('async_write', [True, False])
def test_close_drains_to_the_last_save(tmp_path, async_write):
    """Real writes: after close() the file holds the last save, as the JAX
    saver's does."""
    out, jout = tmp_path / 'torch', tmp_path / 'jax'
    for d in (out, jout):
        d.mkdir()
    saver = ckpt.ModelSaver(async_write=async_write)
    jsaver = jckpt.ModelSaver(async_write=async_write)
    for i in range(5):
        _port_save(saver, str(out), i)
        _jax_save(jsaver, str(jout), i)
    saver.close()
    jsaver.close()
    assert ckpt.load_checkpoint(str(out))['iteration'] == 4
    assert jckpt.load_checkpoint_raw(str(jout))[1]['iteration'] == 4
    assert not os.path.exists(str(out / 'checkpoint.pt.tmp'))


def test_only_best(monkeypatch, tmp_path):
    """Best-only mode skips a save whose loss is worse than the best so
    far (a tie saves), with the JAX saver's answers."""
    losses = [0.5, 0.7, 0.4, 0.4, 0.6, None]
    answers, written = {}, {}
    for pkg, (mod, save, iteration_of) in PACKAGES.items():
        log = _recording_writer(monkeypatch, mod, iteration_of)
        saver = mod.ModelSaver(only_best=True)
        answers[pkg] = [save(saver, str(tmp_path), i, loss)
                        for i, loss in enumerate(losses)]
        saver.close()
        written[pkg] = log['written']
    assert answers['torch'] == answers['jax'] == \
        [True, False, True, True, False, True]
    # the writer may skip superseded saves; the last one always lands
    assert written['torch'][-1] == written['jax'][-1] == 5


@pytest.mark.parametrize('pkg', list(PACKAGES))
def test_write_error_raised_at_next_save(pkg, monkeypatch, tmp_path):
    """A failed background write comes back as RuntimeError('async
    checkpoint write failed'), caused by the write's error, at the next
    save; that save is dropped and close() then raises nothing."""
    mod, save, iteration_of = PACKAGES[pkg]
    _recording_writer(monkeypatch, mod, iteration_of, fail=True)
    saver = mod.ModelSaver()
    save(saver, str(tmp_path), 0)
    deadline = time.time() + WAIT
    while saver._error is None and time.time() < deadline:
        time.sleep(0.005)
    with pytest.raises(RuntimeError, match='async checkpoint write failed') \
            as err:
        save(saver, str(tmp_path), 1)
    assert isinstance(err.value.__cause__, OSError)
    saver.close()


@pytest.mark.parametrize('pkg', list(PACKAGES))
def test_write_error_raised_at_close(pkg, monkeypatch, tmp_path):
    mod, save, iteration_of = PACKAGES[pkg]
    _recording_writer(monkeypatch, mod, iteration_of, fail=True)
    saver = mod.ModelSaver()
    save(saver, str(tmp_path), 0)
    with pytest.raises(RuntimeError, match='async checkpoint write failed'):
        saver.close()


def test_snapshot_unchanged_by_a_later_step(monkeypatch, tmp_path):
    """The snapshot is taken at the call: an Adam step taken in place after
    it, while the writer still holds the job, changes neither the weights
    nor the optimizer state (moments and step count) that are written.
    On the CPU ``.cpu()`` returns the live tensor itself, so only a copy
    keeps them apart."""
    torch.manual_seed(0)
    model = torch.nn.Linear(4, 3)
    opt = torch.optim.Adam(model.parameters(), lr=0.1)

    def step():
        opt.zero_grad()
        model(torch.ones(2, 4)).square().sum().backward()
        opt.step()

    step()
    want_model = {k: v.clone() for k, v in model.state_dict().items()}
    want_opt = {i: {k: v.clone() for k, v in s.items()}
                for i, s in opt.state_dict()['state'].items()}
    gate = threading.Event()
    jobs = []
    monkeypatch.setattr(ckpt, '_write_checkpoint',
                        lambda *job: (gate.wait(WAIT), jobs.append(job)))
    saver = ckpt.ModelSaver()
    saver(str(tmp_path), model, opt, Config(), 0, 1, 0.5)
    step()
    gate.set()
    saver.close()
    (_, payload), = jobs
    assert payload['iteration'] == 1
    for k, v in want_model.items():
        assert torch.equal(payload['model_state_dict'][k], v), k
        assert not torch.equal(model.state_dict()[k], v), k
    for i, s in want_opt.items():
        for k, v in s.items():
            assert torch.equal(payload['optimizer_state_dict']['state'][i][k],
                               v), (i, k)
    assert int(opt.state_dict()['state'][0]['step']) == 2


# ------------------------------------------------------------- the loop


@pytest.fixture(scope='module')
def data_dirs(tmp_path_factory):
    from mmlf_tpu_torch.data.synth import generate_dataset
    root = tmp_path_factory.mktemp('torch_checkpoint')
    train_dir, val_dir = str(root / 'train'), str(root / 'val')
    generate_dataset(train_dir, scenes=1, size=64, seed=0)
    generate_dataset(val_dir, scenes=1, size=64, seed=7)
    return train_dir, val_dir


def _cfg(data_dirs, **kw):
    train_dir, val_dir = data_dirs
    return Config(train_trainset=train_dir, train_valset=val_dir,
                  train_bs=2, train_ps=32, train_max_downscale=1,
                  val_interval=1, val_loss_margin=5, train_steps=2,
                  model_chs=4, model_in_blocks=1, model_out_blocks=1,
                  **kw).finalize()


@pytest.mark.parametrize('raise_in_step', [False, True])
def test_loop_drain_never_masks_an_exception(data_dirs, tmp_path,
                                             monkeypatch, capfd,
                                             raise_in_step):
    """Every write fails.  A clean loop raises the write error when its
    ``finally`` drains the saver; a loop whose step raised keeps that
    exception and only reports the write error (the JAX loop's rule)."""
    from mmlf_tpu_torch.train import loop

    def fail(*job):
        raise OSError('disk full')

    monkeypatch.setattr(ckpt, '_write_checkpoint', fail)
    if raise_in_step:
        orig = loop.train_step

        def step(cfg, model, optimizer, cache, batch, i, **kw):
            if i == 1:
                raise ValueError('step 1 failed')
            return orig(cfg, model, optimizer, cache, batch, i, **kw)

        monkeypatch.setattr(loop, 'train_step', step)
    want = (ValueError, 'step 1 failed') if raise_in_step else \
        (RuntimeError, 'async checkpoint write failed')
    with pytest.raises(want[0], match=want[1]):
        loop.train(_cfg(data_dirs), str(tmp_path), progress=False,
                   device='cpu')
    if raise_in_step:
        assert 'checkpoint writer failed during shutdown' in \
            capfd.readouterr().err
    assert not os.path.exists(os.path.join(str(tmp_path), 'checkpoint.pt'))
