"""Fused gossip mix:  y = w₀·x₀ + Σᵢ wᵢ·xᵢ.

Port of the Pallas kernel ``repro.kernels.gossip_mix.gossip_mix``
(``src/repro/kernels/gossip_mix.py:24-50``): the W-row AXPY over the self
view and the neighbour views, reading every stream once.  On CUDA tensors
:func:`gossip_mix` launches the hand-written kernel in
``csrc/gossip_mix.cu``; on CPU tensors it runs
:func:`repro_torch.kernels.ref.gossip_mix_ref`.  Weights are Python floats
(the topology is fixed for a run), rounded to f32 at the launch.

One launch takes at most :data:`LAUNCH_INPUTS` inputs.  More inputs (the
exponential graph's 1 + 2·⌈log₂K⌉ shifts, 9 at K = 16) run as a chain of
launches: each launch after the first takes the partial sum as its first
input with weight 1.0.  ``1.0·acc`` is exact, so the chain rounds exactly
as one left-to-right sum does.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import LANE
from repro_torch.kernels import build
from repro_torch.kernels._check import check_matrix
from repro_torch.kernels.ref import gossip_mix_ref

__all__ = ["gossip_mix", "LAUNCH_INPUTS", "launch_count", "LANE"]

LAUNCH_INPUTS = 8       # kMaxInputs in csrc/gossip_mix.cu

_ARGTYPES = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
             ctypes.c_void_p, ctypes.c_longlong, ctypes.c_void_p]


def launch_count(n: int) -> int:
    """Kernel launches of one mix of ``n`` inputs on a CUDA tensor:
    1 + ⌈(n − 8)/7⌉ past 8 inputs."""
    return 1 + max(0, -(-(n - LAUNCH_INPUTS) // (LAUNCH_INPUTS - 1)))


def _mix_once(tensors, weights):
    """One launch over at most :data:`LAUNCH_INPUTS` inputs (the plain
    version on a CPU tensor)."""
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


def gossip_mix(tensors, *, weights):
    """tensors: sequence of n ≥ 1 (rows, LANE) f32 tensors on one device;
    weights: n floats.  Returns a fresh (rows, LANE) tensor."""
    tensors = tuple(tensors)
    weights = tuple(float(w) for w in weights)
    if not tensors or len(weights) != len(tensors):
        raise ValueError(f"need at least one tensor and one weight each, "
                         f"got {len(tensors)} and {len(weights)}")
    for i, t in enumerate(tensors):
        check_matrix(t, f"tensors[{i}]", like=tensors[0] if i else None)
    step = LAUNCH_INPUTS - 1
    acc = _mix_once(tensors[:LAUNCH_INPUTS], weights[:LAUNCH_INPUTS])
    for i in range(LAUNCH_INPUTS, len(tensors), step):
        acc = _mix_once((acc,) + tensors[i:i + step],
                        (1.0,) + weights[i:i + step])
    return acc


gossip_mix.launches = 0     # kernel launches since the last reset
