"""The round's spans (:mod:`repro_torch.spans`) in a profiler's trace.

A tiny ``SimTrainer.train`` of two rounds at p = 2 runs under a CPU
``torch.profiler``; its exported chrome trace must hold each span as many
times as the round opens it, nested as the module says.  Without a
profiler no span reaches ``record_function``, and the spans change no
number the run computes.
"""
import json

import pytest
import torch
from torch.autograd import profiler as autograd_profiler
from torch.profiler import ProfilerActivity, profile

from repro_torch import spans
from repro_torch.core import (DenseComm, make_compressor, make_optimizer,
                              make_topology)
from repro_torch.train.trainer import SimTrainer

K, P, ROUNDS = 4, 2, 2
# flattens a round on the kernel layout: x and m (CPD: x̂ too) once; each
# local step's gradient is read as leaves by the momentum launch, not
# flattened
FLATTENS = {"pd": 2, "cpd": 3}


def _loss(params, batch):
    h = torch.tanh(batch["x"] @ params["w"])
    return ((h @ params["v"] - batch["y"]) ** 2).mean(), {}


def _params():
    g = torch.Generator().manual_seed(0)
    return {"w": torch.randn(K, 8, 6, generator=g) * 0.3,
            "v": torch.randn(K, 6, generator=g) * 0.3}


def _batch(t):
    g = torch.Generator().manual_seed(100 + t)
    return {"x": torch.randn(K, 5, 8, generator=g),
            "y": torch.randn(K, 5, generator=g)}


def _trainer(kind, use_kernel=True):
    comm = DenseComm(make_topology("ring", (K,)), device="cpu")
    comp = make_compressor("sign") if kind == "cpd" else None
    opt = make_optimizer("cpd_sgdm" if kind == "cpd" else "pd_sgdm", comm,
                         eta=0.1, mu=0.9, p=P, weight_decay=1e-4,
                         compressor=comp, use_kernel=use_kernel)
    return SimTrainer(_loss, opt, device="cpu")


def _train(trainer, **kw):
    return trainer.train(_params(), _batch, ROUNDS * P, **kw)


def _annotations(prof, tmp_path) -> list:
    """``(name, start, end)`` of each program span in the chrome trace."""
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    with open(path) as f:
        events = json.load(f)["traceEvents"]
    return [(e["name"], e["ts"], e["ts"] + e["dur"]) for e in events
            if e.get("cat") == "user_annotation" and e.get("ph") == "X"
            and e["name"] in spans.NAMES]


def _traced(trainer, tmp_path, **kw) -> list:
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        _train(trainer, **kw)
    return _annotations(prof, tmp_path)


def _count(found, name) -> int:
    return sum(n == name for n, _s, _e in found)


def _inside(inner, outer) -> bool:
    return outer[1] <= inner[1] and inner[2] <= outer[2]


def _of(found, name) -> list:
    return [a for a in found if a[0] == name]


@pytest.mark.parametrize("kind", ["pd", "cpd"])
def test_kernel_round_spans(kind, tmp_path):
    found = _traced(_trainer(kind), tmp_path, rounds_per_log=1)
    assert _count(found, spans.ROUND_GRAD) == ROUNDS * P
    assert _count(found, spans.MODEL_FORWARD) == ROUNDS * P
    assert _count(found, spans.ROUND_EXCHANGE) == ROUNDS
    assert _count(found, spans.LAYOUT_FLATTEN) == ROUNDS * FLATTENS[kind]
    # one flush a block, and a block is a round here
    assert _count(found, spans.TRAINER_FLUSH) == ROUNDS
    grads = _of(found, spans.ROUND_GRAD)
    for fwd in _of(found, spans.MODEL_FORWARD):
        assert any(_inside(fwd, g) for g in grads)
    layout = (_of(found, spans.LAYOUT_FLATTEN)
              + _of(found, spans.LAYOUT_UNFLATTEN))
    exchanges = _of(found, spans.ROUND_EXCHANGE)
    for lay in layout:
        assert not any(_inside(lay, g) for g in grads)
        assert not any(_inside(lay, x) for x in exchanges)


def test_one_flush_a_block(tmp_path):
    # at the default log_every the two rounds are one block
    found = _traced(_trainer("pd"), tmp_path)
    assert _count(found, spans.TRAINER_FLUSH) == 1
    assert _count(found, spans.ROUND_EXCHANGE) == ROUNDS


@pytest.mark.parametrize("kind", ["pd", "cpd"])
def test_tree_round_spans(kind, tmp_path):
    found = _traced(_trainer(kind, use_kernel=False), tmp_path)
    assert _count(found, spans.ROUND_GRAD) == ROUNDS * P
    assert _count(found, spans.MODEL_FORWARD) == ROUNDS * P
    assert _count(found, spans.ROUND_EXCHANGE) == ROUNDS
    # the tree round flattens nothing itself; CPD's sign codec packs each
    # leaf through a plan of its own, inside the exchange
    exchanges = _of(found, spans.ROUND_EXCHANGE)
    layout = (_of(found, spans.LAYOUT_FLATTEN)
              + _of(found, spans.LAYOUT_UNFLATTEN))
    assert bool(layout) == (kind == "cpd")
    for lay in layout:
        assert any(_inside(lay, x) for x in exchanges)


class _Counting(autograd_profiler.record_function):
    entered = 0

    def __enter__(self):
        type(self).entered += 1
        return super().__enter__()


def test_no_profiler_no_record_function(monkeypatch):
    monkeypatch.setattr(autograd_profiler, "record_function", _Counting)
    _Counting.entered = 0
    _train(_trainer("cpd"))
    assert _Counting.entered == 0
    # the patch is where the spans look: under a profiler they enter it
    with profile(activities=[ProfilerActivity.CPU]):
        _train(_trainer("cpd"))
    assert _Counting.entered > 0


@pytest.mark.parametrize("kind", ["pd", "cpd"])
def test_spans_change_no_number(kind):
    x_off, _, hist_off = _train(_trainer(kind), log_every=1)
    with profile(activities=[ProfilerActivity.CPU]):
        x_on, _, hist_on = _train(_trainer(kind), log_every=1)
    assert hist_on.loss == hist_off.loss
    for name in x_off:
        assert torch.equal(x_on[name], x_off[name])


def test_guard_follows_the_profiler():
    # the flag that spans.span reads: a torch that renames it fails here
    assert autograd_profiler._is_profiler_enabled is False
    assert spans.span("x") is spans.span("y")
    with profile(activities=[ProfilerActivity.CPU]):
        assert autograd_profiler._is_profiler_enabled is True
        assert isinstance(spans.span("x"), autograd_profiler.record_function)
    assert autograd_profiler._is_profiler_enabled is False
    assert spans.span("x") is spans.span("y")
