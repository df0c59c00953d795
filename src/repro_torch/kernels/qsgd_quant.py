"""Blockwise QSGD quantization with bit-packed levels.

Port of the Pallas kernels ``repro.kernels.qsgd_quant.qsgd_quant_pallas``
and ``qsgd_dequant_pallas`` (``src/repro/kernels/qsgd_quant.py:39-118``),
CPD-SGDM's codec on the QSGD wire.  One row of the flatten-once layout is
one quantization block:

  * :func:`qsgd_quant`: x ``(R, LANE)`` f32 → levels ``(R, LANE·bits/8)``
    u8 and norms ``(R, 1)`` f32 (``norm = max|x|``,
    ``u = rint(x·s/norm) + s``);
  * :func:`qsgd_dequant`: the inverse, ``(u − s)·(inv_s·norm)``, ``+0``
    where the norm is 0.

``bits = qsgd_bits(levels)`` ∈ {2, 4, 8}.  On CUDA tensors each wrapper
launches its hand-written kernel in ``csrc/qsgd_quant.cu``; on CPU tensors
it runs the plain version in :mod:`repro_torch.kernels.ref`.  Zero padding
quantizes to the centre level and decodes to exactly 0, so no counts
operand is needed.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import LANE
from repro_torch.kernels import build
from repro_torch.kernels._check import (check_matrix, check_operand,
                                        plain_route, row_count)
from repro_torch.kernels.ref import (qsgd_bits, qsgd_inv_levels,
                                     qsgd_rows_ref, qsgd_rows_unpack_ref)

__all__ = ["qsgd_quant", "qsgd_dequant", "packed_width", "LANE"]

_QUANT_ARGTYPES = [ctypes.c_void_p] * 3 + [ctypes.c_longlong, ctypes.c_float,
                                           ctypes.c_int, ctypes.c_void_p]
_DEQUANT_ARGTYPES = [ctypes.c_void_p] * 3 + [ctypes.c_longlong,
                                             ctypes.c_float, ctypes.c_float,
                                             ctypes.c_int, ctypes.c_void_p]


def packed_width(levels: int) -> int:
    """Bytes per packed row at ``levels``: ``LANE·bits/8``."""
    return LANE * qsgd_bits(levels) // 8


def _levels(levels) -> int:
    if isinstance(levels, bool) or not isinstance(levels, int) or levels < 1:
        raise ValueError(f"levels must be an int ≥ 1, got {levels!r}")
    return levels


def qsgd_quant(x, *, levels: int):
    """x: (R, LANE) f32.  Returns fresh ``(packed (R, LANE·bits/8) u8,
    norms (R, 1) f32)``."""
    levels = _levels(levels)
    bits = qsgd_bits(levels)
    rows = row_count(x, "x")
    check_matrix(x, "x")
    if plain_route(x):
        return qsgd_rows_ref(x, levels)
    fn = build.load_function("qsgd_quant", "qsgd_quant_f32", _QUANT_ARGTYPES)
    packed = torch.empty((rows, packed_width(levels)), dtype=torch.uint8,
                         device=x.device)
    norms = torch.empty((rows, 1), dtype=torch.float32, device=x.device)
    with torch.cuda.device(x.device):
        err = fn(x.data_ptr(), packed.data_ptr(), norms.data_ptr(), rows,
                 float(levels), bits, torch.cuda.current_stream().cuda_stream)
    if err:
        raise RuntimeError(f"qsgd_quant launch failed: CUDA error {err}")
    qsgd_quant.launches += 1
    return packed, norms


def qsgd_dequant(packed, norms, *, levels: int):
    """packed: (R, LANE·bits/8) u8; norms: (R, 1) f32 on its device.
    Returns a fresh (R, LANE) f32."""
    levels = _levels(levels)
    bits = qsgd_bits(levels)
    rows = row_count(packed, "packed")
    check_operand(packed, "packed", torch.uint8, (rows, packed_width(levels)),
                  packed.device)
    check_operand(norms, "norms", torch.float32, (rows, 1), packed.device)
    if plain_route(packed):
        return qsgd_rows_unpack_ref(packed, norms, levels)
    fn = build.load_function("qsgd_quant", "qsgd_dequant_f32",
                             _DEQUANT_ARGTYPES)
    out = torch.empty((rows, LANE), dtype=torch.float32, device=packed.device)
    with torch.cuda.device(packed.device):
        err = fn(packed.data_ptr(), norms.data_ptr(), out.data_ptr(), rows,
                 float(levels), qsgd_inv_levels(levels), bits,
                 torch.cuda.current_stream().cuda_stream)
    if err:
        raise RuntimeError(f"qsgd_dequant launch failed: CUDA error {err}")
    qsgd_dequant.launches += 1
    return out


qsgd_quant.launches = 0       # kernel launches since the last reset
qsgd_dequant.launches = 0
