"""A run with its timed path broken underneath reports ``correct`` false,
once for each fault a cell can have: a step that leaves its state (or
only its parameters) as it was, half of each microbatch left out (the
mean over the rest), an ESE member's answer altered where it is
produced, and half of the members left out.  (One chip: there is no
exchange between chips to leave out.)"""

import pytest
import torch

from test_bench_cpu_run import run_tiny

TRAIN = ['upr_bf16_trunk.train', 'upr_fp32.train', 'upr_fp32_trunk.train']
# the cells whose bn_stats_gap limit, at CPU size, lets pass the running
# statistics of a step that keeps only its parameters (the fp32 K3 cell's
# limit, 5.41e-6, also catches them: 5.6e-6)
BN_PASSES_KEPT_PARAMETERS = {'upr_bf16_trunk.train', 'upr_fp32.train'}


@pytest.mark.parametrize('kept, reads_1', [('state', 'bn_stats_gap'),
                                            ('parameters', 'change_gap')])
@pytest.mark.parametrize('name', TRAIN)
def test_step_that_keeps_its_state(tiny, name, kept, reads_1, monkeypatch):
    """The step leaves its whole state as it was, or only its parameters:
    then Adam's moments and the running statistics still move, and the
    update never reaches the parameters: ``change_gap`` catches it."""
    from mmlf_tpu_torch.train import loop
    step = loop.train_step

    def unchanged(cfg, model, optimizer, *a, **k):
        state = model.state_dict() if kept == 'state' else \
            dict(model.named_parameters())
        state = {k_: v.detach().clone() for k_, v in state.items()}
        loss = step(cfg, model, optimizer, *a, **k)
        model.load_state_dict(state, strict=kept == 'state')
        return loss

    monkeypatch.setattr(loop, 'train_step', unchanged)
    res = run_tiny(tiny, name)
    assert res['correct'] is False
    # the leaves that did not move read 1: the worst leaf's gap is 1
    assert res['checks'][reads_1]['value'] == pytest.approx(1.0)
    if kept == 'parameters':
        bn = res['checks']['bn_stats_gap']
        assert (bn['value'] <= bn['limit']) is \
            (name in BN_PASSES_KEPT_PARAMETERS)


@pytest.mark.parametrize('name', TRAIN)
def test_half_of_each_microbatch(tiny, name, monkeypatch):
    from mmlf_tpu_torch.data.pipeline import chunk_slice
    from mmlf_tpu_torch.train import loop
    mb = loop.microbatch_loss

    def half(cfg, model, cache, chunk, step):
        return mb(cfg, model, cache,
                  chunk_slice(chunk, 0, len(chunk.scene) // 2), step)

    monkeypatch.setattr(loop, 'microbatch_loss', half)
    assert run_tiny(tiny, name)['correct'] is False


def test_member_altered_where_produced(tiny, monkeypatch):
    from mmlf_tpu_torch.models import ensemble as E
    members = E._run_members

    def altered(*a, **k):
        means, logvars, best_lv, best_mean = members(*a, **k)
        means[-1] += 0.5
        return means, logvars, best_lv, best_mean

    monkeypatch.setattr(E, '_run_members', altered)
    res = run_tiny(tiny, 'upr_fp32.ese')
    assert res['correct'] is False
    assert res['checks']['member_mean_gap']['value'] >= 0.5 - 1e-3


def test_half_of_the_members(tiny, monkeypatch):
    from mmlf_tpu_torch.models import ensemble as E
    from mmlf_tpu_torch.validate import cli as V
    grid = E.ensemble_grid
    for owner in (E, V):
        monkeypatch.setattr(owner, 'ensemble_grid',
                            lambda *a: grid(*a)[::2])
    assert run_tiny(tiny, 'upr_fp32.ese')['correct'] is False


def test_unaltered_run_is_correct(tiny):
    torch.manual_seed(0)
    assert run_tiny(tiny, 'upr_fp32.ese')['correct'] is True
