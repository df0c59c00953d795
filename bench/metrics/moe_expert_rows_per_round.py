"""Rows a round that the expert layers hand their routed experts'
products: the change over the traced window of the program's counter
``moe.expert_rows`` (held experts × groups × capacity, of one worker's
shapes, each layer call) over its rounds.  Padding rows past an
expert's slots count; the rows a perfectly packed dispatch would need
are the slots kept.  None where the program has no such counter."""
ROWS = "moe.expert_rows"


def read(trace):
    rows = trace.counters.get(ROWS)
    return rows / trace.rounds if rows is not None else None
