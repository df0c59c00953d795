"""Device milliseconds a round of the expert layers' routing work,
forward: the device work launched inside the program's spans
``moe.route`` (the router, its top-k and the load-balance loss),
``moe.dispatch`` (the sort of the slots into the experts' buffer) and
``moe.combine`` (the gated sum back onto the tokens), put down by
:func:`bench.spans.device_ms`.  The backward's launches come from
autograd's thread after the forward has closed the spans, so this is
forward work alone."""
from bench import spans

ROUTING = ("moe.route", "moe.dispatch", "moe.combine")


def read(trace):
    ms = spans.device_ms(trace.events, ROUTING)
    return ms / trace.rounds if ms is not None else None
