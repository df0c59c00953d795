"""Blockwise scaled sign with 8 signs per byte.

Port of the Pallas kernels ``repro.kernels.sign_compress.sign_pack_pallas``
and ``sign_unpack_pallas`` (``src/repro/kernels/sign_compress.py:44-110``),
CPD-SGDM's codec on the 1-bit wire.  One row of the flatten-once layout is
one scale block:

  * :func:`sign_pack`: x ``(R, LANE)`` f32 and the valid element count of
    each row ``(R, 1)`` f32 (``KernelPlan.row_counts``, tiled over the
    workers) → bits ``(R, LANE/8)`` u8 and scales ``(R, 1)`` f32;
  * :func:`sign_unpack`: the inverse, ``(2·bit − 1)·scale``.

On CUDA tensors each wrapper launches its hand-written kernel in
``csrc/sign_compress.cu``; on CPU tensors it runs the plain version in
:mod:`repro_torch.kernels.ref`.  The scale's sum is the fixed tree of
:func:`repro_torch.kernels.ref.tree_sum` in both, so they agree bit for bit.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import LANE
from repro_torch.kernels import build
from repro_torch.kernels._check import (check_matrix, check_operand,
                                        plain_route, row_count)
from repro_torch.kernels.ref import sign_pack_rows_ref, sign_unpack_ref

__all__ = ["sign_pack", "sign_unpack", "PACKED", "LANE"]

PACKED = LANE // 8      # bytes per packed row

_PACK_ARGTYPES = [ctypes.c_void_p] * 4 + [ctypes.c_longlong, ctypes.c_void_p]
_UNPACK_ARGTYPES = [ctypes.c_void_p] * 3 + [ctypes.c_longlong,
                                            ctypes.c_void_p]


def sign_pack(x, counts):
    """x: (R, LANE) f32; counts: (R, 1) f32 on x's device.  Returns fresh
    ``(packed (R, LANE/8) u8, scales (R, 1) f32)``."""
    rows = row_count(x, "x")
    check_matrix(x, "x")
    check_operand(counts, "counts", torch.float32, (rows, 1), x.device)
    if plain_route(x):
        return sign_pack_rows_ref(x, counts)
    fn = build.load_function("sign_compress", "sign_pack_f32", _PACK_ARGTYPES)
    packed = torch.empty((rows, PACKED), dtype=torch.uint8, device=x.device)
    scales = torch.empty((rows, 1), dtype=torch.float32, device=x.device)
    with torch.cuda.device(x.device):
        err = fn(x.data_ptr(), counts.data_ptr(), packed.data_ptr(),
                 scales.data_ptr(), rows,
                 torch.cuda.current_stream().cuda_stream)
    if err:
        raise RuntimeError(f"sign_pack launch failed: CUDA error {err}")
    sign_pack.launches += 1
    return packed, scales


def sign_unpack(packed, scales):
    """packed: (R, LANE/8) u8; scales: (R, 1) f32 on its device.  Returns a
    fresh (R, LANE) f32."""
    rows = row_count(packed, "packed")
    check_operand(packed, "packed", torch.uint8, (rows, PACKED),
                  packed.device)
    check_operand(scales, "scales", torch.float32, (rows, 1), packed.device)
    if plain_route(packed):
        return sign_unpack_ref(packed, scales)
    fn = build.load_function("sign_compress", "sign_unpack_f32",
                             _UNPACK_ARGTYPES)
    out = torch.empty((rows, LANE), dtype=torch.float32, device=packed.device)
    with torch.cuda.device(packed.device):
        err = fn(packed.data_ptr(), scales.data_ptr(), out.data_ptr(), rows,
                 torch.cuda.current_stream().cuda_stream)
    if err:
        raise RuntimeError(f"sign_unpack launch failed: CUDA error {err}")
    sign_unpack.launches += 1
    return out


sign_pack.launches = 0       # kernel launches since the last reset
sign_unpack.launches = 0
