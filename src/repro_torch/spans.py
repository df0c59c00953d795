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
  host sync, the log and any eval.
"""
from __future__ import annotations

import contextlib

from torch.autograd import profiler as _profiler

__all__ = ["ROUND_GRAD", "MODEL_FORWARD", "LAYOUT_FLATTEN",
           "LAYOUT_UNFLATTEN", "ROUND_EXCHANGE", "TRAINER_FLUSH", "NAMES",
           "span"]

ROUND_GRAD = "round.grad"
MODEL_FORWARD = "model.forward"
LAYOUT_FLATTEN = "layout.flatten"
LAYOUT_UNFLATTEN = "layout.unflatten"
ROUND_EXCHANGE = "round.exchange"
TRAINER_FLUSH = "trainer.flush"
NAMES = (ROUND_GRAD, MODEL_FORWARD, LAYOUT_FLATTEN, LAYOUT_UNFLATTEN,
         ROUND_EXCHANGE, TRAINER_FLUSH)

# nullcontext keeps no state, so one instance serves every span
_OFF = contextlib.nullcontext()


def span(name: str):
    """A ``record_function(name)`` range while a profiler collects (the
    flag ``torch.profiler.profile`` sets on entry and clears on exit),
    else the shared empty context."""
    if _profiler._is_profiler_enabled:
        return _profiler.record_function(name)
    return _OFF
