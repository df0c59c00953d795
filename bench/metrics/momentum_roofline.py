"""The momentum kernel's share of its HBM roofline: the bytes each launch
needs (``yardstick.momentum_bytes``: read x, m and g, write x and m) at
3.35 TB/s, over the kernel's device time, summed over its launches."""
from bench import tracing, yardstick


def read(trace):
    runs = [d for d in trace.dev if tracing.kind(d[0], d[1]) == "momentum"]
    if not runs:
        return None
    ms = sum(d[3] - d[2] for d in runs) * 1e-3
    bound = yardstick.bound_ms(
        yardstick.momentum_bytes(trace.workers, trace.elems), trace.peaks)
    return 100.0 * bound * len(runs) / ms
