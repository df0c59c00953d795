"""Device milliseconds a round of copies and fills (``tracing.kind``
"copy_fill": copy and fill kernels, memcpy, memset), the layout's and the
model's alike."""


def read(trace):
    ms = trace.ms_by_kind.get("copy_fill")
    return ms / trace.rounds if ms else None
