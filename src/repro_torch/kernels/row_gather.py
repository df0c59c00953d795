"""Row gather and scatter: the data movers of the sparse-rows wire.

Port of the Pallas kernels ``repro.kernels.row_gather.row_gather_pallas``
and ``row_scatter_pallas`` (``src/repro/kernels/row_gather.py:48-123``).
The sparse-rows codec ships S selected rows of each worker's flatten-once
matrix:

  * :func:`row_gather`: x ``(K, rows, LANE)`` f32, idx ``(K, S)`` i32 and
    the counts ``(K·rows, 1)`` f32 tiled over the workers (None for full
    rows) → ``(K, S, LANE)`` f32, ``out[k, j] = x[k, idx[k, j]]`` with the
    lanes at or past that row's count set to +0.0;
  * :func:`row_scatter`: idx ``(K, S)`` and vals ``(K, S, LANE)`` →
    ``(K, rows, LANE)`` zeros with ``out[k, idx[k, j]] += vals[k, j]``.
    The indices of a worker are distinct and sorted (the codec selects
    them so); the plain version checks that on the CPU, the kernel trusts
    it.

The reference launches its kernels once per worker; here one launch takes
all K workers.  On CUDA tensors each wrapper launches its hand-written
kernel in ``csrc/row_gather.cu``; on CPU tensors it runs the plain version
in :mod:`repro_torch.kernels.ref`.  Both only move rows, so the two agree
bit for bit.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import LANE
from repro_torch.kernels import build
from repro_torch.kernels._check import check_operand, plain_route
from repro_torch.kernels.ref import row_gather_ref, row_scatter_ref

__all__ = ["row_gather", "row_scatter", "LANE"]

_GATHER_ARGTYPES = ([ctypes.c_void_p] * 4
                    + [ctypes.c_longlong, ctypes.c_longlong, ctypes.c_int,
                       ctypes.c_void_p])
_SCATTER_ARGTYPES = ([ctypes.c_void_p] * 3
                     + [ctypes.c_longlong, ctypes.c_longlong, ctypes.c_int,
                        ctypes.c_void_p])


def _workers_and_slots(idx) -> tuple:
    if not (isinstance(idx, torch.Tensor) and idx.dim() == 2
            and idx.shape[0] > 0 and idx.shape[1] > 0):
        raise ValueError(f"idx: expected a (K, S) tensor with K, S ≥ 1, "
                         f"got {getattr(idx, 'shape', type(idx))}")
    return tuple(idx.shape)


def row_gather(x, idx, counts=None):
    """x: (K, rows, LANE) f32; idx: (K, S) i32; counts: (K·rows, 1) f32 or
    None, all on x's device.  Returns a fresh (K, S, LANE) f32."""
    k, s = _workers_and_slots(idx)
    rows = x.shape[1] if isinstance(x, torch.Tensor) and x.dim() == 3 else -1
    check_operand(x, "x", torch.float32, (k, rows, LANE), x.device)
    check_operand(idx, "idx", torch.int32, (k, s), x.device)
    if counts is not None:
        check_operand(counts, "counts", torch.float32, (k * rows, 1),
                      x.device)
    if plain_route(x):
        return row_gather_ref(x, idx, counts)
    fn = build.load_function("row_gather", "row_gather_f32", _GATHER_ARGTYPES)
    out = torch.empty((k, s, LANE), dtype=torch.float32, device=x.device)
    with torch.cuda.device(x.device):
        err = fn(x.data_ptr(), idx.data_ptr(),
                 0 if counts is None else counts.data_ptr(), out.data_ptr(),
                 k, rows, s, torch.cuda.current_stream().cuda_stream)
    if err:
        raise RuntimeError(f"row_gather launch failed: CUDA error {err}")
    row_gather.launches += 1
    return out


def row_scatter(idx, vals, *, rows: int):
    """idx: (K, S) i32; vals: (K, S, LANE) f32 on its device.  Returns a
    fresh (K, rows, LANE) f32: a zero fill, then the kernel writes the
    K·S rows."""
    k, s = _workers_and_slots(idx)
    if isinstance(rows, bool) or not isinstance(rows, int) or rows < 1:
        raise ValueError(f"rows must be an int ≥ 1, got {rows!r}")
    check_operand(idx, "idx", torch.int32, (k, s), idx.device)
    check_operand(vals, "vals", torch.float32, (k, s, LANE), idx.device)
    if plain_route(idx):
        return row_scatter_ref(idx, vals, rows=rows)
    fn = build.load_function("row_gather", "row_scatter_f32",
                             _SCATTER_ARGTYPES)
    out = torch.zeros((k, rows, LANE), dtype=torch.float32, device=idx.device)
    with torch.cuda.device(idx.device):
        err = fn(idx.data_ptr(), vals.data_ptr(), out.data_ptr(), k, rows, s,
                 torch.cuda.current_stream().cuda_stream)
    if err:
        raise RuntimeError(f"row_scatter launch failed: CUDA error {err}")
    row_scatter.launches += 1
    return out


row_gather.launches = 0      # kernel launches since the last reset
row_scatter.launches = 0
