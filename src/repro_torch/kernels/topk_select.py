"""Blockwise magnitude top-k: CPD-SGDM's codec on the top-k wire.

Port of the Pallas kernels ``repro.kernels.topk_select.topk_select_pallas``
and ``topk_scatter_pallas`` (``src/repro/kernels/topk_select.py:44-125``).
One row of the flatten-once layout is one top-k block:

  * :func:`topk_select`: x ``(R, LANE)`` f32 and the valid element count
    of each row ``(R, 1)`` f32 (``KernelPlan.row_counts``, tiled over the
    workers; None for full rows) → idx ``(R, W)`` i32 and vals ``(R, W)``
    f32 with ``W = max(1, ceil(fraction·LANE))``: slot j holds the j-th
    largest |x| of the row, ties to the lowest index, while ``j <
    ceil(f32(fraction)·count)``, and ``(0, 0.0)`` after;
  * :func:`topk_scatter`: the inverse, ``+0.0`` rows with
    ``out[idx_j] += val_j``.

On CUDA tensors each wrapper launches its hand-written kernel in
``csrc/topk_select.cu`` (a radix select on the |x| bits; a scatter of the
nonzero slots in parallel, whose adds flush subnormals as the card's
``scatter_add`` does); on CPU tensors it runs the plain version in
:mod:`repro_torch.kernels.ref`.  ``MAX_WIDTH`` caps W, as the reference's
select kernel caps its unrolled rounds: ``TopKCodec.rows_supported`` reads
it to choose between the kernel wire and the per-leaf codec, as the
reference does.
"""
from __future__ import annotations

import ctypes

import numpy as np
import torch

from repro_torch.kernels import LANE
from repro_torch.kernels import build
from repro_torch.kernels._check import (check_matrix, check_operand,
                                        plain_route, row_count)
from repro_torch.kernels.ref import (topk_rows_ref, topk_rows_unpack_ref,
                                     topk_width)

__all__ = ["topk_select", "topk_scatter", "LANE", "BLOCK_ROWS", "MAX_WIDTH"]

# The reference kernels' row tile; the port's plan pads rows to
# PLAN_BLOCK_ROWS = 256, a multiple of it, and the CUDA kernels take any
# row count.
BLOCK_ROWS = 128
# The widest payload the select kernel takes (the reference's unroll cap).
MAX_WIDTH = 128

_SELECT_ARGTYPES = ([ctypes.c_void_p] * 4
                    + [ctypes.c_longlong, ctypes.c_int, ctypes.c_float,
                       ctypes.c_void_p])
_SCATTER_ARGTYPES = ([ctypes.c_void_p] * 3
                     + [ctypes.c_longlong, ctypes.c_int, ctypes.c_void_p])


def _width(fraction) -> int:
    if isinstance(fraction, bool) or not (
            isinstance(fraction, (int, float)) and 0.0 < fraction <= 1.0):
        raise ValueError(f"fraction must be a float in (0, 1], got "
                         f"{fraction!r}")
    w = topk_width(fraction, LANE)
    if w > MAX_WIDTH:
        raise ValueError(f"top-k width {w} > {MAX_WIDTH}: the select kernel "
                         "takes at most MAX_WIDTH slots; coarse fractions go "
                         "through the per-leaf codec")
    return w


def topk_select(x, counts=None, *, fraction: float):
    """x: (R, LANE) f32; counts: (R, 1) f32 on x's device or None (full
    rows).  Returns fresh ``(idx (R, W) i32, vals (R, W) f32)``."""
    w = _width(fraction)
    rows = row_count(x, "x")
    check_matrix(x, "x")
    if counts is not None:
        check_operand(counts, "counts", torch.float32, (rows, 1), x.device)
    if plain_route(x):
        return topk_rows_ref(x, counts, fraction=fraction, width=w)
    fn = build.load_function("topk_select", "topk_select_f32",
                             _SELECT_ARGTYPES)
    idx = torch.empty((rows, w), dtype=torch.int32, device=x.device)
    vals = torch.empty((rows, w), dtype=torch.float32, device=x.device)
    with torch.cuda.device(x.device):
        err = fn(x.data_ptr(), 0 if counts is None else counts.data_ptr(),
                 idx.data_ptr(), vals.data_ptr(), rows, w,
                 float(np.float32(fraction)),
                 torch.cuda.current_stream().cuda_stream)
    if err:
        raise RuntimeError(f"topk_select launch failed: CUDA error {err}")
    topk_select.launches += 1
    return idx, vals


def topk_scatter(idx, vals):
    """idx: (R, W) i32; vals: (R, W) f32 on its device.  Returns a fresh
    (R, LANE) f32."""
    rows = row_count(idx, "idx")
    w = idx.shape[-1] if idx.dim() == 2 else -1
    if not 1 <= w <= MAX_WIDTH:
        raise ValueError(f"idx: shape {tuple(idx.shape)}, expected (R, W) "
                         f"with 1 ≤ W ≤ {MAX_WIDTH}")
    check_operand(idx, "idx", torch.int32, (rows, w), idx.device)
    check_operand(vals, "vals", torch.float32, (rows, w), idx.device)
    if plain_route(idx):
        return topk_rows_unpack_ref(idx, vals, LANE)
    fn = build.load_function("topk_select", "topk_scatter_f32",
                             _SCATTER_ARGTYPES)
    out = torch.empty((rows, LANE), dtype=torch.float32, device=idx.device)
    with torch.cuda.device(idx.device):
        err = fn(idx.data_ptr(), vals.data_ptr(), out.data_ptr(), rows, w,
                 torch.cuda.current_stream().cuda_stream)
    if err:
        raise RuntimeError(f"topk_scatter launch failed: CUDA error {err}")
    topk_scatter.launches += 1
    return out


topk_select.launches = 0     # kernel launches since the last reset
topk_scatter.launches = 0
