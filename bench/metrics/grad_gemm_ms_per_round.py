"""Device milliseconds a round of matrix-product kernels (cuBLAS and
CUTLASS, by name) that the optimizer's exchange did not launch
(``tracing.kind`` "gemm"): the gradients' products.  CPD's ``W @ x̂`` is
launched inside the exchange's span and is left out."""


def read(trace):
    ms = trace.ms_by_kind.get("gemm")
    return ms / trace.rounds if ms else None
