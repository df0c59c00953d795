"""The program's own spans in a traced window: device time and idle time
put down to the step of the program that caused them.

The program opens a ``record_function`` span at each layer boundary of
its round while a profiler collects (``repro_torch.spans``, whose names
are repeated here: only :mod:`bench.program` imports the program), so
the spans lie in the same trace as the device events, on one clock:

* a device event of the window belongs to a span when the runtime or
  driver call that launched it (same ``correlation`` id) starts inside
  one of that span's host intervals, on any thread: the backward's
  launches come from autograd's device thread while the calling thread
  waits inside :data:`ROUND_GRAD`.  An outer span holds its inner spans'
  work;
* an idle gap of the window belongs to a span when it begins inside one
  of the span's host intervals: the host was there when the card ran
  dry.

Both return None where the trace holds none of the spans asked for (a
program that has no spans), and 0 where the spans are there but nothing
fell in them.  They read the whole trace's events, host and device,
which a per-layer reader finds in :class:`bench.harness.Traced`'s
``events``.
"""
from __future__ import annotations

from bench import tracing

ROUND_GRAD = "round.grad"
MODEL_FORWARD = "model.forward"
LAYOUT_FLATTEN = "layout.flatten"
LAYOUT_UNFLATTEN = "layout.unflatten"
ROUND_EXCHANGE = "round.exchange"
TRAINER_FLUSH = "trainer.flush"


def intervals(events: list, names: tuple) -> list:
    """The union of the host intervals of the spans named in ``names``,
    as disjoint sorted ``(start, end)``."""
    found = [iv for name in names for iv in tracing.spans(events, name)]
    return tracing.union(found, float("-inf"), float("inf"))


def device_ms(events: list, names: tuple):
    """Device milliseconds of the window's events (a sum of durations)
    whose launching call starts inside a span in ``names``."""
    ivs = intervals(events, names)
    if not ivs:
        return None
    starts = [s for s, _ in ivs]
    lo, hi = tracing.window(events)
    launched = {e["args"]["correlation"]: e["ts"] for e in events
                if e.get("cat") in tracing.LAUNCH_CATS
                and "correlation" in e.get("args", {})}
    us = 0.0
    for e in events:
        if e.get("ph") != "X" or e.get("cat") not in tracing.DEVICE_CATS \
                or not lo <= e["ts"] < hi:
            continue
        at = launched.get(e.get("args", {}).get("correlation"))
        if at is not None and tracing._inside(at, starts, ivs):
            us += e["dur"]
    return us * 1e-3


def idle_ms(events: list, dev: list, names: tuple):
    """Milliseconds of the window's idle gaps (:func:`bench.tracing.gaps`
    over the device events ``dev``) that begin inside a span in
    ``names``."""
    ivs = intervals(events, names)
    if not ivs:
        return None
    starts = [s for s, _ in ivs]
    lo, hi = tracing.window(events)
    return sum(e - s for s, e in tracing.gaps(dev, lo, hi)
               if tracing._inside(s, starts, ivs)) * 1e-3
