"""Hand-written CUDA kernels for the port's memory-bound hot spots.

momentum       — fused SGDM update (PD-SGDM and CPD-SGDM inner loop)
gossip_mix     — fused W-row neighbour AXPY (PD-SGDM gossip)
sign_compress  — blockwise scaled-sign pack / unpack (CPD-SGDM sign wire)
qsgd_quant     — blockwise QSGD quantize / dequantize (CPD-SGDM QSGD wire)
topk_select    — blockwise top-k select / scatter (CPD-SGDM top-k wire)
row_gather     — row gather / scatter (CPD-SGDM sparse-rows wire)

Each kernel module holds a wrapper that checks its operands, launches the
CUDA kernel on a CUDA tensor (or raises) and runs the plain PyTorch version
from :mod:`repro_torch.kernels.ref` on a CPU tensor (and on a meta tensor,
where it only propagates shapes: the dry run's), plus a plain integer
``launches`` counter on the wrapper.  Sources live in ``csrc/`` and are
compiled for ``sm_90a`` at first use (:mod:`repro_torch.kernels.build`).
``ops.py`` holds the flatten-once ``KernelPlan`` layout.
"""

# Elements per row of the flatten-once (rows, LANE) layout — the single
# definition in the port; every other width derives from it.
LANE = 1024  # lint: allow
