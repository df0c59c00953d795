"""Device milliseconds a round of the expert layers' products, forward:
the device work launched inside the program's span ``moe.experts`` (the
held routed experts' and the shared experts' products), put down by
:func:`bench.spans.device_ms`.  The backward's launches come from
autograd's thread after the forward has closed the span, so this is
forward work alone."""
from bench import spans

EXPERTS = "moe.experts"


def read(trace):
    ms = spans.device_ms(trace.events, (EXPERTS,))
    return ms / trace.rounds if ms is not None else None
