"""Fused gossip mix:  y = w₀·v₀ + Σⱼ wⱼ·vⱼ.

Port of the Pallas kernel ``repro.kernels.gossip_mix.gossip_mix``
(``src/repro/kernels/gossip_mix.py:24-50``): the W-row AXPY over the self
view and the neighbour views, reading every stream once.  Two entry points
launch the one hand-written kernel in ``csrc/gossip_mix.cu`` on CUDA
tensors and run their plain versions from :mod:`repro_torch.kernels.ref`
on CPU tensors:

* :func:`gossip_mix` mixes n distinct matrices (MT-DSGDm's tracking AXPYs,
  ``ops.delayed_mix_mat``);
* :func:`gossip_mix_shifted` mixes one topology axis of a static shift
  graph: every view is a ``(K, rows, 1024)`` matrix read at a worker-grid
  shift, neighbour rows past the wire extent read as zero.  The self view
  reads ``x``; the neighbour views read ``x`` too, or a second matrix of
  the same shape (the bf16 wire's f32 round trip of the payload).  The
  kernel reads the views in place: no rolled or re-padded copy.

Weights are Python floats (the topology is fixed for a run), rounded to f32
at the launch.  One launch takes at most :data:`LAUNCH_INPUTS` inputs.
More run as a chain of launches: each launch after the first takes the
partial sum as its first input with weight 1.0.  ``1.0·acc`` is exact, so
the chain rounds exactly as one left-to-right sum does.
"""
from __future__ import annotations

import ctypes
import math

import torch

from repro_torch.kernels import LANE
from repro_torch.kernels import build
from repro_torch.kernels._check import (check_matrix, check_operand,
                                        plain_route)
from repro_torch.kernels.ref import gossip_mix_ref, gossip_shift_ref

__all__ = ["gossip_mix", "gossip_mix_shifted", "LAUNCH_INPUTS",
           "launch_count", "LANE"]

LAUNCH_INPUTS = 32      # kMaxInputs in csrc/gossip_mix.cu


class _View(ctypes.Structure):
    """One kernel input (``View`` in csrc/gossip_mix.cu)."""
    _fields_ = [("x", ctypes.c_void_p), ("w", ctypes.c_float),
                ("shift", ctypes.c_int), ("lim", ctypes.c_longlong)]


_ARGTYPES = [ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_longlong,
             ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
             ctypes.c_void_p]


def launch_count(n: int) -> int:
    """Kernel launches of one mix of ``n`` inputs on a CUDA tensor:
    1 up to 32 inputs, then 1 + ⌈(n − 32)/31⌉."""
    step = LAUNCH_INPUTS - 1
    return 1 + max(0, -(-(n - LAUNCH_INPUTS) // step))


def _launch(views, *, k, rows, inner, size, force_stream):
    """One kernel launch over ≤ :data:`LAUNCH_INPUTS` views, each
    ``(tensor, weight, shift, lim)``; returns a fresh tensor shaped as the
    first view's.  The kernel picks its design from the views;
    ``force_stream`` takes the stream design where it would take the tile
    (to time the two on the same views)."""
    fn = build.load_function("gossip_mix", "gossip_mix_f32", _ARGTYPES)
    arr = (_View * len(views))(*(_View(t.data_ptr(), w, sh, lim)
                                 for (t, w, sh, lim) in views))
    out = torch.empty_like(views[0][0])
    with torch.cuda.device(out.device):
        err = fn(arr, len(views), k, rows, inner, size, int(force_stream),
                 out.data_ptr(), torch.cuda.current_stream().cuda_stream)
    if err:
        raise RuntimeError(f"gossip_mix launch failed: CUDA error {err}")
    gossip_mix.launches += 1
    return out


def _mix(views, *, force_stream=False, **geometry):
    """Chain launches of at most :data:`LAUNCH_INPUTS` views, each later
    one taking the partial sum (identity map, every row) with weight 1.0."""
    step = LAUNCH_INPUTS - 1
    acc = _launch(views[:LAUNCH_INPUTS], force_stream=force_stream,
                  **geometry)
    for i in range(LAUNCH_INPUTS, len(views), step):
        acc = _launch(((acc, 1.0, 0, geometry["rows"]),) + views[i:i + step],
                      force_stream=force_stream, **geometry)
    return acc


def _check_weights(n, weights, what):
    weights = tuple(float(w) for w in weights)
    if n == 0 or len(weights) != n:
        raise ValueError(f"need at least one {what} and one weight each, "
                         f"got {n} and {len(weights)}")
    return weights


def gossip_mix(tensors, *, weights):
    """tensors: sequence of n ≥ 1 (rows, LANE) f32 tensors on one device;
    weights: n floats.  Returns a fresh (rows, LANE) tensor."""
    tensors = tuple(tensors)
    weights = _check_weights(len(tensors), weights, "tensor")
    for i, t in enumerate(tensors):
        check_matrix(t, f"tensors[{i}]", like=tensors[0] if i else None)
    if plain_route(tensors[0]):
        return gossip_mix_ref(tensors, weights)
    rows = tensors[0].shape[0]
    return _mix(tuple((t, w, 0, rows) for t, w in zip(tensors, weights)),
                k=1, rows=rows, inner=1, size=1)


def gossip_mix_shifted(x, *, grid, axis: int, shifts, weights, lim=None,
                       nbr=None, _force_stream: bool = False):
    """One topology axis of a static shift graph on the kernel layout.

    x: (K, rows, LANE) f32, K = prod(grid) workers in a row-major grid;
    shifts and weights: one per view.  View j gives worker k the matrix of
    the worker ``shifts[j]`` further along ``axis`` (``DenseComm._roll``),
    its rows from ``lim`` on zero unless ``shifts[j] == 0`` (``lim``: the
    wire extent, ``rows`` by default).  The view of shift 0 reads ``x``,
    every other view reads ``nbr`` (``x`` by default; an f32 matrix shaped
    as ``x``, on its device).  Returns the fresh (K, rows, LANE)
    ``Σⱼ wⱼ·viewⱼ``, summed left to right.  ``_force_stream`` launches the
    stream design where the kernel would take the tile, to time the two."""
    grid = tuple(int(g) for g in grid)
    shifts = tuple(int(s) for s in shifts)
    weights = _check_weights(len(shifts), weights, "shift")
    if x.dim() != 3 or math.prod(grid) != x.shape[0]:
        raise ValueError(f"x: shape {tuple(x.shape)} is not (K, rows, "
                         f"{LANE}) over the worker grid {grid}")
    k, rows = x.shape[0], x.shape[1]
    check_operand(x, "x", torch.float32, (k, rows, LANE), x.device)
    if not 0 <= axis < len(grid):
        raise ValueError(f"axis {axis} is not an axis of the grid {grid}")
    if nbr is None:
        nbr = x
    else:
        check_operand(nbr, "nbr", torch.float32, (k, rows, LANE), x.device)
    lim = rows if lim is None else min(int(lim), rows)
    if lim < 0:
        raise ValueError(f"lim {lim} < 0")
    if plain_route(x):
        return gossip_shift_ref(x, shifts, weights, grid=grid, axis=axis,
                                lim=lim, nbr=nbr)
    size = grid[axis]
    inner = math.prod(grid[axis + 1:])
    views = tuple((x, w, 0, rows) if sh == 0 else (nbr, w, sh % size, lim)
                  for sh, w in zip(shifts, weights))
    return _mix(views, k=k, rows=rows, inner=inner, size=size,
                force_stream=_force_stream)


gossip_mix.launches = 0     # kernel launches since the last reset
