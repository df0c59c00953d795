"""CUDA kernel launches a round: the kernels that ran in the traced
window over its rounds (memcpy and memset are not kernels)."""


def read(trace):
    n = sum(1 for d in trace.dev if d[1] == "kernel")
    return n / trace.rounds if n else None
