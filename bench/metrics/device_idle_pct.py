"""The share of the traced window in which no device operation ran: the
window less the union of the kernel, memcpy and memset intervals."""


def read(trace):
    if trace.window_s <= 0:
        return None
    return 100.0 * (1.0 - trace.busy_s / trace.window_s)
