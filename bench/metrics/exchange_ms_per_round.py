"""Device milliseconds a round of the exchange at the round's end: the
device work launched inside the program's span ``round.exchange`` (the
gossip, or CPD's consensus, drift, codec and x-hat update), put down by
:func:`bench.spans.device_ms`."""
from bench import spans


def read(trace):
    ms = spans.device_ms(trace.events, (spans.ROUND_EXCHANGE,))
    return ms / trace.rounds if ms is not None else None
