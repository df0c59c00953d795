"""The program's spans in a trace (``bench/spans.py``), on a synthetic
chrome trace (``trace_spans.json``): a 1,000 us window of two rounds,
each a flatten, a gradient (a forward inside it, and a backward kernel
launched from a second thread while the first is inside the gradient's
span), a flatten of the gradient, a momentum kernel outside every span,
an exchange and a flush, whose copy to the host is followed by an idle
gap.  A kernel launched inside the last flush runs after the window.
The five span metrics' readers on the same trace through
:class:`bench.harness.Traced`.  Then on the traces of the tiny cells'
program on the CPU."""
import os
import tempfile
from pathlib import Path

import pytest

from bench import harness, spans, spec, tracing, weights
from bench.spec import ROOT, reader

FIXTURE = Path(__file__).with_name("trace_spans.json")
NO_SPANS = Path(__file__).with_name("trace_small.json")
DEVICE = {
    "round.grad": (spans.ROUND_GRAD,),
    "model.forward": (spans.MODEL_FORWARD,),
    "layout": (spans.LAYOUT_FLATTEN, spans.LAYOUT_UNFLATTEN),
    "round.exchange": (spans.ROUND_EXCHANGE,),
}
IDLE = {"trainer.flush": (spans.TRAINER_FLUSH,)}


class Window:
    """A trace's events, its window and the window's device events."""

    def __init__(self, events: list):
        self.events = events
        self.lo, self.hi = tracing.window(events)
        self.dev = tracing.device_events(events, self.lo, self.hi)

    def read(self, group: str):
        if group in IDLE:
            return spans.idle_ms(self.events, self.dev, IDLE[group])
        return spans.device_ms(self.events, DEVICE[group])


@pytest.fixture(scope="module")
def fixture():
    return Window(tracing.load(FIXTURE))


@pytest.mark.parametrize("group,want", [
    # the sgemms (50, 30 us) and the backward's kernels (80, 40 us),
    # launched from the second thread, over two rounds
    ("round.grad", 0.200),
    # the sgemms alone: the backward's launches begin after the forward
    ("model.forward", 0.080),
    # fill 10 and copy 15, the gradients' copies 12 and 10; the unflatten
    # launches nothing
    ("layout", 0.047),
    # the gossip kernels, launched by the driver's call (18, 20 us)
    ("round.exchange", 0.038),
    # 1,475-1,625 and 1,880-2,000 us; the gap at 1,430-1,470 ends inside
    # the first flush but began before it
    ("trainer.flush", 0.270),
])
def test_span_ms(fixture, group, want):
    assert fixture.read(group) == pytest.approx(want)


@pytest.mark.parametrize("group", [*DEVICE, *IDLE])
def test_trace_without_spans_is_none(group):
    assert Window(tracing.load(NO_SPANS)).read(group) is None


def test_spans_and_momentum_hold_the_busy_time(fixture):
    # all but the flushes' two 5 us copies to the host
    names = (spans.ROUND_GRAD, spans.LAYOUT_FLATTEN, spans.LAYOUT_UNFLATTEN,
             spans.ROUND_EXCHANGE)
    momentum = tracing.ms_by_kind(fixture.dev)["momentum"]
    busy_ms = tracing.busy_us(fixture.dev, fixture.lo, fixture.hi) * 1e-3
    assert spans.device_ms(fixture.events, names) + momentum == \
        pytest.approx(busy_ms - 0.010)
    assert spans.device_ms(fixture.events, (spans.TRAINER_FLUSH,)) == \
        pytest.approx(0.010)


def test_spans_found_but_empty_read_zero(fixture):
    assert spans.device_ms(fixture.events, (spans.LAYOUT_UNFLATTEN,)) == 0.0
    # no gap begins in the unflatten: the one around it began at 1,475 us
    assert spans.idle_ms(fixture.events, fixture.dev,
                         (spans.LAYOUT_UNFLATTEN,)) == 0.0


@pytest.mark.parametrize("cell", ["tiny-dense.pd", "tiny-ssd.pd",
                                  "tiny-dense.cpd"])
def test_tiny_program_trace_holds_every_span(tiny_root, cell):
    # two rounds of the cell's program under the profiler, as a traced
    # window runs them: the program opens every span this module names
    # (found, so 0 and not None, with no device event on the CPU)
    from torch.profiler import ProfilerActivity, profile, record_function
    setup = harness.Setup(spec.load(cell, root=tiny_root), 11, "cpu")
    t = setup.cell.traffic
    x = weights.stack(setup.x0(), t["workers"])
    feed = setup.stream(2 * setup.p).feed(0)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        with record_function(tracing.WINDOW):
            setup.prog.train(x, feed, 2 * setup.p)
    fd, path = tempfile.mkstemp(suffix=".json")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        window = Window(tracing.load(path))
    finally:
        os.unlink(path)
    assert window.dev == []
    assert {g: window.read(g) for g in [*DEVICE, *IDLE]} == \
        dict.fromkeys([*DEVICE, *IDLE], 0.0)


@pytest.mark.parametrize("measure", ["device", "idle"])
def test_nested_span_counts_once(fixture, measure):
    # every model.forward lies inside a round.grad: asking for both reads
    # the outer span alone
    def read(names):
        if measure == "device":
            return spans.device_ms(fixture.events, names)
        return spans.idle_ms(fixture.events, fixture.dev, names)
    assert read((spans.ROUND_GRAD, spans.MODEL_FORWARD)) == \
        pytest.approx(read((spans.ROUND_GRAD,)))


@pytest.mark.parametrize("measure", ["device", "idle"])
def test_disjoint_spans_add_up(fixture, measure):
    def read(names):
        if measure == "device":
            return spans.device_ms(fixture.events, names)
        return spans.idle_ms(fixture.events, fixture.dev, names)
    both = read((spans.ROUND_EXCHANGE, spans.TRAINER_FLUSH))
    assert both == pytest.approx(read((spans.ROUND_EXCHANGE,))
                                 + read((spans.TRAINER_FLUSH,)))


def test_intervals_are_disjoint_and_sorted(fixture):
    ivs = spans.intervals(fixture.events,
                          (spans.ROUND_GRAD, spans.MODEL_FORWARD))
    # two rounds: each forward inside its gradient
    assert ivs == [(1100, 1300), (1600, 1750)]


SPAN_METRICS = ("grad_ms_per_round", "forward_ms_per_round",
                "layout_ms_per_round", "exchange_ms_per_round",
                "flush_idle_ms_per_round")


class _Root:
    root = ROOT


def _traced(window: Window, rounds: int) -> harness.Traced:
    return harness.Traced(
        dev=window.dev, window_s=(window.hi - window.lo) * 1e-6,
        busy_s=tracing.busy_us(window.dev, window.lo, window.hi) * 1e-6,
        rounds=rounds, tokens=1000, seq=4, workers=2, elems=1000, blocks=1,
        model={}, peaks={}, ms_by_kind=tracing.ms_by_kind(window.dev),
        events=window.events)


@pytest.mark.parametrize("metric,want", [
    # the fixture's two rounds, each sum worked above from its events:
    # sgemms 50 + 30 us and backward kernels 80 + 40 us
    ("grad_ms_per_round", 0.200 / 2),
    # the sgemms alone
    ("forward_ms_per_round", 0.080 / 2),
    # fill 10, copy 15, the gradients' copies 12 and 10
    ("layout_ms_per_round", 0.047 / 2),
    # the gossip kernels, 18 and 20 us
    ("exchange_ms_per_round", 0.038 / 2),
    # the gaps at 1,475-1,625 and 1,880-2,000 us
    ("flush_idle_ms_per_round", 0.270 / 2),
])
def test_span_metric_readers(fixture, metric, want):
    assert reader(_Root(), metric)(_traced(fixture, 2)) == \
        pytest.approx(want)


@pytest.mark.parametrize("metric", SPAN_METRICS)
def test_span_metric_without_spans_is_left_out(metric):
    # a trace with no program span, and a Traced that carries no events
    bare = _traced(Window(tracing.load(NO_SPANS)), 2)
    assert reader(_Root(), metric)(bare) is None
    assert reader(_Root(), metric)(
        harness.Traced(**{**bare.__dict__, "events": []})) is None


def test_span_metrics_and_momentum_hold_the_busy_ms(fixture):
    # gradient + layout + exchange + momentum: the busy time a round, less
    # the flushes' two 5 us copies to the host
    traced = _traced(fixture, 2)
    read = {m: reader(_Root(), m)(traced) for m in SPAN_METRICS}
    momentum = traced.ms_by_kind["momentum"] / 2
    assert read["grad_ms_per_round"] + read["layout_ms_per_round"] + \
        read["exchange_ms_per_round"] + momentum == \
        pytest.approx(traced.busy_s * 1e3 / 2 - 0.005)


def test_traced_window_carries_the_programs_spans(tiny_root):
    # the harness's traced window of the tiny dense cell on the CPU: the
    # trace's events hold the program's gradient and flush spans, and
    # each counter's change over the window is there
    setup = harness.Setup(spec.load("tiny-dense.pd", root=tiny_root), 12,
                          "cpu")
    x = weights.stack(setup.x0(), setup.cell.traffic["workers"])
    traced, _brk, _hist = harness.traced_window(
        setup, x, setup.stream(2 * setup.p).feed(0), 2)
    names = {e.get("name") for e in traced.events
             if e.get("cat") == "user_annotation"}
    assert {spans.ROUND_GRAD, spans.TRAINER_FLUSH} <= names
    assert len(tracing.spans(traced.events, spans.ROUND_GRAD)) == \
        2 * setup.p
    assert set(traced.counters) == set(setup.prog.counters())
