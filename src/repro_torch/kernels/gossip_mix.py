"""Fused gossip mix:  y = w₀·x₀ + Σᵢ wᵢ·xᵢ.

Port of the Pallas kernel ``repro.kernels.gossip_mix.gossip_mix``
(``src/repro/kernels/gossip_mix.py:24-50``): the W-row AXPY over the self
view and the neighbour views, reading every stream once.  On CUDA tensors
:func:`gossip_mix` launches the hand-written kernel in
``csrc/gossip_mix.cu``; on CPU tensors it runs
:func:`repro_torch.kernels.ref.gossip_mix_ref`.  Weights are Python floats
(the topology is fixed for a run), rounded to f32 at the launch.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import LANE
from repro_torch.kernels import build
from repro_torch.kernels._check import check_matrix
from repro_torch.kernels.ref import gossip_mix_ref

__all__ = ["gossip_mix", "MAX_INPUTS", "LANE"]

MAX_INPUTS = 8          # kMaxInputs in csrc/gossip_mix.cu

_ARGTYPES = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
             ctypes.c_void_p, ctypes.c_longlong, ctypes.c_void_p]


def gossip_mix(tensors, *, weights):
    """tensors: sequence of n (rows, LANE) f32 tensors on one device;
    weights: n floats.  Returns a fresh (rows, LANE) tensor."""
    tensors = tuple(tensors)
    weights = tuple(float(w) for w in weights)
    if not 1 <= len(tensors) <= MAX_INPUTS or len(weights) != len(tensors):
        raise ValueError(f"need 1..{MAX_INPUTS} tensors and one weight each, "
                         f"got {len(tensors)} and {len(weights)}")
    for i, t in enumerate(tensors):
        check_matrix(t, f"tensors[{i}]", like=tensors[0] if i else None)
    x0 = tensors[0]
    if x0.device.type == "cpu":
        return gossip_mix_ref(tensors, weights)
    fn = build.load_function("gossip_mix", "gossip_mix_f32", _ARGTYPES)
    n = len(tensors)
    ptrs = (ctypes.c_void_p * n)(*(t.data_ptr() for t in tensors))
    ws = (ctypes.c_float * n)(*weights)
    out = torch.empty_like(x0)
    with torch.cuda.device(x0.device):
        err = fn(ptrs, ws, n, out.data_ptr(), x0.numel(),
                 torch.cuda.current_stream().cuda_stream)
    if err:
        raise RuntimeError(f"gossip_mix launch failed: CUDA error {err}")
    gossip_mix.launches += 1
    return out


gossip_mix.launches = 0     # kernel launches since the last reset
