"""Milliseconds a round in which the card ran dry while the host was in
the trainer's flush: the idle gaps of the window that begin inside the
program's span ``trainer.flush`` (a block's one host sync, the log and
any eval), put down by :func:`bench.spans.idle_ms`."""
from bench import spans


def read(trace):
    ms = spans.idle_ms(trace.events, trace.dev, (spans.TRAINER_FLUSH,))
    return ms / trace.rounds if ms is not None else None
