"""The round's spans (:mod:`repro_torch.spans`) in a profiler's trace.

A tiny ``SimTrainer.train`` of two rounds at p = 2 runs under a CPU
``torch.profiler``; its exported chrome trace must hold each span as many
times as the round opens it, nested as the module says.  Without a
profiler no span reaches ``record_function``, and the spans change no
number the run computes.  On a tiny DeepSeek-V2 cut the MLA span and the
expert layer's four spans open once a layer and step, and
``spans.counters()`` counts the expert layer's slots and rows from its
shapes; the benchmark's four readers of them give the sums worked by
hand on a hand-built trace, and nothing where the program has neither.
"""
import json
import sys
from pathlib import Path

import pytest
import torch
from torch.autograd import profiler as autograd_profiler
from torch.profiler import ProfilerActivity, profile

from repro_torch import spans
from repro_torch.configs.base import LayerSpec, ModelCfg
from repro_torch.core import (DenseComm, make_compressor, make_optimizer,
                              make_topology)
from repro_torch.models import make_model
from repro_torch.models.moe import MoECfg, capacity
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


# ------------------------------------------------- MLA and expert layers
ROOT = Path(__file__).resolve().parents[1]
# a tiny DeepSeek-V2 cut: a dense and two expert layers, all MLA with a
# direct query; 8 experts of which 2 are held, top 3, 2 shared experts
TINY_DS = dict(
    name="tiny-deepseek", arch_type="moe", n_layers=3, d_model=32,
    n_heads=4, n_kv_heads=4, d_ff=48, vocab=64, tie_embeddings=False,
    pattern=(LayerSpec("mla", "dense"), LayerSpec("mla", "moe"),
             LayerSpec("mla", "moe")),
    n_experts=8, top_k=3, moe_d_ff=12, n_shared_experts=2, experts_held=2,
    moe_norm_topk=False, use_mla=True, q_lora_rank=0, kv_lora_rank=16,
    qk_nope_dim=8, qk_rope_dim=4, v_head_dim=8)
SEQ, BATCH = 16, 2
MOE_SPANS = (spans.MOE_ROUTE, spans.MOE_DISPATCH, spans.MOE_EXPERTS,
             spans.MOE_COMBINE)


def _deepseek_run(tmp_path, traced=True):
    """Two rounds at p = 2 of PD-SGDM on the tiny cut's kernel layout,
    under a CPU profiler where ``traced``: ``(spans found, counters'
    change)``."""
    model = make_model(ModelCfg(**TINY_DS))
    init = model.init(torch.Generator().manual_seed(0), device="cpu")
    params = {n: t.expand((K,) + tuple(t.shape)).clone()
              for n, t in init.items()}

    def batch(t):
        g = torch.Generator().manual_seed(200 + t)
        toks = torch.randint(0, 64, (K, BATCH, SEQ + 1), generator=g)
        return {"tokens": toks[..., :-1], "labels": toks[..., 1:]}
    opt = make_optimizer("pd_sgdm",
                         DenseComm(make_topology("ring", (K,)),
                                   device="cpu"),
                         eta=0.1, mu=0.9, p=P, weight_decay=1e-4,
                         use_kernel=True)
    trainer = SimTrainer(model.loss, opt, device="cpu")
    before = spans.counters()
    if not traced:
        trainer.train(params, batch, ROUNDS * P)
        return None, _change(before)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        trainer.train(params, batch, ROUNDS * P)
    return _annotations(prof, tmp_path), _change(before)


def _change(before: dict) -> dict:
    return {k: v - before.get(k, 0) for k, v in spans.counters().items()}


def test_mla_and_moe_spans_once_a_layer_and_step(tmp_path):
    found, _ = _deepseek_run(tmp_path)
    steps = ROUNDS * P
    assert _count(found, spans.ATTN_MLA) == 3 * steps
    for name in MOE_SPANS:
        assert _count(found, name) == 2 * steps, name
    # each inside a forward, and the four of a layer in order, disjoint
    forwards = _of(found, spans.MODEL_FORWARD)
    for name in (spans.ATTN_MLA,) + MOE_SPANS:
        for a in _of(found, name):
            assert any(_inside(a, f) for f in forwards)
    by_layer = zip(*(_of(found, name) for name in MOE_SPANS))
    for route, dispatch, experts, combine in by_layer:
        assert route[2] <= dispatch[1] and dispatch[2] <= experts[1] \
            and experts[2] <= combine[1]


def test_moe_counters_from_shapes(tmp_path):
    _, change = _deepseek_run(tmp_path, traced=False)
    steps, layers = ROUNDS * P, 2
    n = BATCH * SEQ                     # one worker's tokens a call
    C = capacity(n, MoECfg(d_model=32, d_ff=12, n_experts=8, top_k=3))
    assert change[spans.MOE_CALLS] == layers * steps
    assert change[spans.MOE_SLOTS] == n * 3 * layers * steps
    # held · G · C · layers · steps
    assert change[spans.MOE_EXPERT_ROWS] == 2 * 1 * C * layers * steps
    # on the CPU the kernel wrappers run their plain versions, which
    # count no launch and no leaf
    assert all(v == 0 for k, v in change.items()
               if not k.startswith("moe."))


def test_counters_list_the_moe_counts_of_a_model_with_experts():
    # every kernel wrapper's launches and the momentum launch's leaves;
    # the expert layer's counters where the model built last has one
    from repro_torch.analysis.round_check import kernel_launches
    always = set(kernel_launches()) | {"momentum_update.leaf_reads",
                                       "momentum_update.leaf_copies"}
    moe_counts = {spans.MOE_CALLS, spans.MOE_SLOTS, spans.MOE_EXPERT_ROWS}
    make_model(ModelCfg(**TINY_DS))
    assert set(spans.counters()) == always | moe_counts
    make_model(ModelCfg(**dict(TINY_DS, arch_type="dense", pattern=(
        LayerSpec("mla", "dense"),), n_layers=1)))
    assert set(spans.counters()) == always


# the four readers of the expert and MLA layers on a hand-built trace: a
# window of 1,000 us and two rounds; a forward with an MLA span (two
# kernels, 30 + 20 us), an expert layer's four spans (route 5 us,
# dispatch 7 + 3 us, experts 40 us, combine 6 us), a backward kernel of
# 90 us launched from a second thread after the forward, and a second
# round's forward (MLA 25 us, route 4, dispatch 8, experts 35, combine 5)
def _span(name, ts, dur, tid=1):
    return {"ph": "X", "cat": "user_annotation", "name": name, "ts": ts,
            "dur": dur, "pid": 1, "tid": tid}


def _kernel(ts, dur, corr, launch_ts, tid=1):
    return [{"ph": "X", "cat": "cuda_runtime", "name": "cudaLaunchKernel",
             "ts": launch_ts, "dur": 2, "pid": 1, "tid": tid,
             "args": {"correlation": corr}},
            {"ph": "X", "cat": "kernel", "name": f"k{corr}", "ts": ts,
             "dur": dur, "pid": 0, "tid": 7,
             "args": {"correlation": corr}}]


def _hand_trace() -> list:
    ev = [_span("bench.window", 1000, 1000)]
    corr = iter(range(1, 100))

    def forward(at, mla, route, dispatch, experts, combine):
        out = [_span("model.forward", at, 200), _span("attn.mla", at + 10,
                                                      40)]
        for i, d in enumerate(mla):
            out += _kernel(at + 100 + 30 * i, d, next(corr), at + 12 + i)
        t = at + 60
        for name, durs in (("moe.route", route), ("moe.dispatch", dispatch),
                           ("moe.experts", experts),
                           ("moe.combine", combine)):
            out.append(_span(name, t, 20))
            for i, d in enumerate(durs):
                out += _kernel(t + 100 + 10 * i, d, next(corr), t + 2 + i)
            t += 25
        # the backward's kernel, launched from autograd's thread after the
        # forward closed
        out += _kernel(at + 250, 90, next(corr), at + 220, tid=2)
        return out
    ev += forward(1010, (30, 20), (5,), (7, 3), (40,), (6,))
    ev += forward(1500, (25,), (4,), (8,), (35,), (5,))
    return ev


def _reader(metric):
    if str(ROOT) not in sys.path:
        sys.path.insert(0, str(ROOT))
    from bench.spec import reader

    class Root:
        root = ROOT
    return reader(Root(), metric)


def _hand_traced(counters=None):
    from bench import harness, tracing
    events = _hand_trace()
    lo, hi = tracing.window(events)
    dev = tracing.device_events(events, lo, hi)
    return harness.Traced(
        dev=dev, window_s=(hi - lo) * 1e-6,
        busy_s=tracing.busy_us(dev, lo, hi) * 1e-6, rounds=2, tokens=1000,
        seq=16, workers=4, elems=1000, blocks=1, model={}, peaks={},
        ms_by_kind=tracing.ms_by_kind(dev), events=events,
        counters=counters if counters is not None else {})


@pytest.mark.parametrize("metric,want", [
    # MLA: 30 + 20 and 25 us, over two rounds
    ("mla_ms_per_round", (0.050 + 0.025) / 2),
    # route, dispatch and combine: 5 + 7 + 3 + 6 and 4 + 8 + 5 us
    ("moe_dispatch_ms_per_round", (0.021 + 0.017) / 2),
    # the experts' products: 40 and 35 us
    ("moe_experts_ms_per_round", (0.040 + 0.035) / 2),
])
def test_moe_and_mla_span_readers(metric, want):
    assert _reader(metric)(_hand_traced()) == pytest.approx(want)


def test_expert_rows_reader():
    traced = _hand_traced({spans.MOE_EXPERT_ROWS: 30_720, "gossip_mix": 2})
    assert _reader("moe_expert_rows_per_round")(traced) == 15_360


@pytest.mark.parametrize("metric", [
    "mla_ms_per_round", "moe_dispatch_ms_per_round",
    "moe_experts_ms_per_round", "moe_expert_rows_per_round"])
def test_moe_and_mla_readers_without_the_program_are_none(metric):
    # the parent's program: no such span, no such counter
    bare = _hand_traced()
    bare = type(bare)(**{**bare.__dict__, "events": [
        e for e in bare.events
        if e["name"].split(".")[0] not in ("attn", "moe")]})
    assert _reader(metric)(bare) is None
