"""A run with the timed path broken underneath comes out not correct.

Each test skips the harness's look for a card and drives the rest of a
run of a tiny cell on the CPU (``harness.run``), with one fault planted in
the program: a step that returns its state unchanged, half of each batch
left out with the mean taken over the rest, or the exchange between the
workers left out.  The sound run of each cell comes out correct.
"""
import time

import pytest

from bench import harness, spec

from bench_tiny import TINY

CELLS = sorted(TINY)


def _run(tiny_root, name, seed=2 ** 31 + 99):
    cell = spec.load(name, root=tiny_root)
    return harness.run(cell, seed, 0.05, False, "cpu", time.perf_counter(),
                       log=lambda m: None)


def _state_unchanged(monkeypatch):
    from repro_torch.core.pdsgdm import PDSGDM
    monkeypatch.setattr(PDSGDM, "local_step_mat",
                        lambda self, x_mat, mats, g_mat, step: (x_mat, mats))


def _half_batch(monkeypatch):
    from repro_torch.models.transformer import Model
    loss = Model.loss

    def half(self, params, batch, *a, **kw):
        labels = batch["labels"]
        if labels.shape[0] >= 2:
            batch = {k: v[:labels.shape[0] // 2] for k, v in batch.items()}
        else:
            cut = labels.clone()
            cut[..., labels.shape[-1] // 2:] = -1
            batch = dict(batch, labels=cut)
        return loss(self, params, batch, *a, **kw)
    monkeypatch.setattr(Model, "loss", half)


def _no_exchange(monkeypatch):
    from repro_torch.core.cpdsgdm import CPDSGDM
    from repro_torch.core.pdsgdm import PDSGDM
    for cls in (PDSGDM, CPDSGDM):
        monkeypatch.setattr(cls, "comm_round_mat",
                            lambda self, x_mat, mats, *a, **kw: (x_mat, mats))


FAULTS = {"state_unchanged": _state_unchanged, "half_batch": _half_batch,
          "no_exchange": _no_exchange}


@pytest.mark.parametrize("name", CELLS)
def test_sound_run_is_correct(tiny_root, name):
    result = _run(tiny_root, name)
    assert result["correct"], result["checks"]
    assert result["failed"] == 0
    assert list(result)[-1] == "checks"


@pytest.mark.parametrize("name", CELLS)
@pytest.mark.parametrize("fault", sorted(FAULTS))
def test_fault_is_not_correct(tiny_root, monkeypatch, name, fault):
    FAULTS[fault](monkeypatch)
    result = _run(tiny_root, name)
    assert not result["correct"], result["checks"]
