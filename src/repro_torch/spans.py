"""Named spans at the round's layer boundaries, for a profiler's trace.

``with span(ROUND_GRAD): ...`` is a ``torch.profiler.record_function``
range while a ``torch.profiler`` collects, so the span lands in the same
chrome trace as the device events, on the profiler's clock: each kernel
can be put down to the span open on the host when its launch was issued
(the backward's launches, issued from autograd's device thread while the
calling thread waits inside :data:`ROUND_GRAD`, by time), and each idle
stretch of the card to the span the host was in when the card ran dry.
Otherwise a span is one shared empty context: one attribute read, no op
dispatched (an unguarded ``record_function`` costs some 13 µs of host
time and dispatches a profiler op).  Spans follow the profiler alone: no
flag or setting turns them on.

The spans and where they open:

* :data:`ROUND_GRAD`: one local step's ``grads_fn`` call, forward and
  backward (``PDSGDM.round``, ``PDSGDM.kernel_round``);
* :data:`MODEL_FORWARD`: the loss inside ``SimTrainer``'s
  ``vmap(grad_and_value)``, once a step, inside :data:`ROUND_GRAD`;
* :data:`LAYOUT_FLATTEN`, :data:`LAYOUT_UNFLATTEN`: the kernel layout's
  ``KernelPlan.flatten`` and ``unflatten``, never inside
  :data:`ROUND_GRAD`;
* :data:`ROUND_EXCHANGE`: the exchange at a round's end (the gossip, or
  CPD's consensus, drift, codec and ``x̂`` update);
* :data:`TRAINER_FLUSH`: ``SimTrainer.train``'s flush of a block, its one
  host sync, the log and any eval;
* :data:`ATTN_MLA`: the MLA mixer's training pass (``mla_apply``);
* :data:`MOE_ROUTE`, :data:`MOE_DISPATCH`, :data:`MOE_EXPERTS`,
  :data:`MOE_COMBINE`: an expert layer's (``moe_apply``) router and its
  load-balance loss; the sort of its slots into the experts' buffer; the
  routed experts' and the shared experts' products; the weighted sum of
  the slots' outputs back onto their tokens.

These open inside :data:`MODEL_FORWARD`, so they hold forward work alone:
the backward's launches come from autograd's thread after the forward
has closed them.

:func:`counters` are the program's counters by name, counted on the host
from shapes, with no read of the device: each kernel wrapper's launches
(``analysis.round_check.kernel_launches``), the momentum launch's
``momentum_update.leaf_reads`` and ``.leaf_copies``, and an expert
layer's :data:`MOE_CALLS`, :data:`MOE_SLOTS` (N·k of a call) and
:data:`MOE_EXPERT_ROWS` (held·G·C, the rows its expert products are
given), each of one call's shapes: under ``vmap`` one call for all the
stacked workers, of one worker's shapes.  The expert layer's counters
are listed where the model built last has expert layers
(:func:`show_moe`), so that a run of a dense model lists the counters
that model can move.
"""
from __future__ import annotations

import contextlib

from torch.autograd import profiler as _profiler

__all__ = ["ROUND_GRAD", "MODEL_FORWARD", "LAYOUT_FLATTEN",
           "LAYOUT_UNFLATTEN", "ROUND_EXCHANGE", "TRAINER_FLUSH", "ATTN_MLA",
           "MOE_ROUTE", "MOE_DISPATCH", "MOE_EXPERTS", "MOE_COMBINE",
           "NAMES", "MOE_CALLS", "MOE_SLOTS", "MOE_EXPERT_ROWS", "span",
           "count", "counters", "show_moe"]

ROUND_GRAD = "round.grad"
MODEL_FORWARD = "model.forward"
LAYOUT_FLATTEN = "layout.flatten"
LAYOUT_UNFLATTEN = "layout.unflatten"
ROUND_EXCHANGE = "round.exchange"
TRAINER_FLUSH = "trainer.flush"
ATTN_MLA = "attn.mla"
MOE_ROUTE = "moe.route"
MOE_DISPATCH = "moe.dispatch"
MOE_EXPERTS = "moe.experts"
MOE_COMBINE = "moe.combine"
NAMES = (ROUND_GRAD, MODEL_FORWARD, LAYOUT_FLATTEN, LAYOUT_UNFLATTEN,
         ROUND_EXCHANGE, TRAINER_FLUSH, ATTN_MLA, MOE_ROUTE, MOE_DISPATCH,
         MOE_EXPERTS, MOE_COMBINE)

MOE_CALLS = "moe.calls"
MOE_SLOTS = "moe.slots"
MOE_EXPERT_ROWS = "moe.expert_rows"
_COUNTS = dict.fromkeys((MOE_CALLS, MOE_SLOTS, MOE_EXPERT_ROWS), 0)
# whether counters() lists the expert layer's counters
_SHOW_MOE = [False]

# nullcontext keeps no state, so one instance serves every span
_OFF = contextlib.nullcontext()


def span(name: str):
    """A ``record_function(name)`` range while a profiler collects (the
    flag ``torch.profiler.profile`` sets on entry and clears on exit),
    else the shared empty context."""
    if _profiler._is_profiler_enabled:
        return _profiler.record_function(name)
    return _OFF


def count(name: str, n: int = 1):
    """Add ``n`` to the program's counter ``name``."""
    _COUNTS[name] += n


def show_moe(on: bool):
    """List the expert layer's counters in :func:`counters` (a model with
    expert layers was built) or not (one without)."""
    _SHOW_MOE[0] = on


def counters() -> dict:
    """The program's counters by name, as they stand (see the module's
    docstring)."""
    from repro_torch.analysis.round_check import kernel_launches
    from repro_torch.kernels.momentum import momentum_update
    out = dict(kernel_launches())
    for k in ("leaf_reads", "leaf_copies"):
        out[f"momentum_update.{k}"] = getattr(momentum_update, k)
    if _SHOW_MOE[0]:
        out.update(_COUNTS)
    return out
