"""Device milliseconds a round of the model's forward passes: the device
work launched inside the program's span ``model.forward`` (the loss
inside ``vmap(grad_and_value)``, once a step), put down by
:func:`bench.spans.device_ms`."""
from bench import spans


def read(trace):
    ms = spans.device_ms(trace.events, (spans.MODEL_FORWARD,))
    return ms / trace.rounds if ms is not None else None
