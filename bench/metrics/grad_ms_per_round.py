"""Device milliseconds a round of the local steps' gradients: the device
work launched inside the program's span ``round.grad`` (each
``grads_fn`` call, forward and backward), put down by
:func:`bench.spans.device_ms`."""
from bench import spans


def read(trace):
    ms = spans.device_ms(trace.events, (spans.ROUND_GRAD,))
    return ms / trace.rounds if ms is not None else None
