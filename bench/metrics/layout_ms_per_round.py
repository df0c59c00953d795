"""Device milliseconds a round of the kernel layout's flattens and
unflattens: the device work launched inside the program's spans
``layout.flatten`` and ``layout.unflatten``, put down by
:func:`bench.spans.device_ms`."""
from bench import spans


def read(trace):
    ms = spans.device_ms(trace.events, (spans.LAYOUT_FLATTEN,
                                        spans.LAYOUT_UNFLATTEN))
    return ms / trace.rounds if ms is not None else None
