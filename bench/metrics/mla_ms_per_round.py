"""Device milliseconds a round of the MLA mixers' forward passes: the
device work launched inside the program's span ``attn.mla`` (each MLA
layer's training pass), put down by :func:`bench.spans.device_ms`.  The
backward's launches come from autograd's thread after the forward has
closed the span, so this is forward work alone."""
from bench import spans

MLA = "attn.mla"


def read(trace):
    ms = spans.device_ms(trace.events, (MLA,))
    return ms / trace.rounds if ms is not None else None
