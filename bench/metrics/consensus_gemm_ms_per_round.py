"""Device milliseconds a round of matrix-product kernels that the
optimizer's exchange launched (``tracing.kind`` "exchange_gemm"): CPD's
consensus product ``W @ x̂``, kept out of the gradients' products."""


def read(trace):
    ms = trace.ms_by_kind.get("exchange_gemm")
    return ms / trace.rounds if ms else None
