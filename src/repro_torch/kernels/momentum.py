"""Fused SGDM update:  m ← μ·m + (g + wd·x);  x ← x − lr·d.

Port of the Pallas kernel ``repro.kernels.momentum.momentum_update``
(``src/repro/kernels/momentum.py:32-66``), the memory-bound inner loop of
PD-SGDM's local step.  On CUDA tensors :func:`momentum_update` launches
the hand-written kernel in ``csrc/momentum.cu`` (5 streams: x, m, g read
once, x', m' written once); on CPU tensors it runs
:func:`repro_torch.kernels.ref.momentum_update_ref`.

``lr`` is a one-element f32 tensor on the operands' device that the kernel
reads through a pointer, so a learning-rate schedule costs no host sync.

``inplace=True`` writes x' and m' over ``x`` and ``m`` (the C entry
``momentum_update_inplace_f32``, the same arithmetic and bytes): a
caller whose x and m belong to it alone saves two fresh buffers, a copy of
the params each.  On CPU tensors it copies the plain version's result into
``x`` and ``m``.  Both forms count in ``momentum_update.launches``.
"""
from __future__ import annotations

import ctypes

import torch

from repro_torch.kernels import LANE
from repro_torch.kernels import build
from repro_torch.kernels._check import check_matrix, plain_route
from repro_torch.kernels.ref import momentum_update_ref

__all__ = ["momentum_update", "LANE"]

_ARGTYPES = ([ctypes.c_void_p] * 6
             + [ctypes.c_longlong, ctypes.c_float, ctypes.c_float,
                ctypes.c_int, ctypes.c_void_p])
_INPLACE_ARGTYPES = ([ctypes.c_void_p] * 4
                     + [ctypes.c_longlong, ctypes.c_float, ctypes.c_float,
                        ctypes.c_int, ctypes.c_void_p])


def _overlap(a: torch.Tensor, b: torch.Tensor) -> bool:
    """Whether the bytes of contiguous ``a`` and ``b`` overlap."""
    a0, b0 = a.data_ptr(), b.data_ptr()
    return (a0 < b0 + b.numel() * b.element_size()
            and b0 < a0 + a.numel() * a.element_size())


def momentum_update(x, m, g, lr, *, mu: float, wd: float = 0.0,
                    nesterov: bool = False, inplace: bool = False):
    """x, m, g: (rows, LANE) f32; lr: one-element f32 tensor on the same
    device.  Returns fresh ``(x_new, m_new)``, or with ``inplace`` the
    update written over ``x`` and ``m`` and returns ``(x, m)``; ``x``,
    ``m`` and ``g`` must then not overlap."""
    check_matrix(x, "x")
    check_matrix(m, "m", like=x)
    check_matrix(g, "g", like=x)
    if not (isinstance(lr, torch.Tensor) and lr.dtype == torch.float32
            and lr.numel() == 1 and lr.device == x.device):
        raise TypeError("lr must be a one-element float32 tensor on "
                        f"{x.device}")
    # a meta tensor has no bytes to overlap (every data_ptr is 0)
    if inplace and x.device.type != "meta" and (
            _overlap(x, m) or _overlap(x, g) or _overlap(m, g)):
        raise ValueError("momentum_update(inplace=True): x, m and g must "
                         "not overlap")
    if plain_route(x):
        x_new, m_new = momentum_update_ref(x, m, g, lr, mu=mu, wd=wd,
                                           nesterov=nesterov)
        if not inplace:
            return x_new, m_new
        return x.copy_(x_new), m.copy_(m_new)
    lr = lr.contiguous()
    if inplace:
        fn = build.load_function("momentum", "momentum_update_inplace_f32",
                                 _INPLACE_ARGTYPES)
        x_out, m_out = x, m
        args = (x.data_ptr(), m.data_ptr(), g.data_ptr(), lr.data_ptr())
    else:
        fn = build.load_function("momentum", "momentum_update_f32",
                                 _ARGTYPES)
        x_out = torch.empty_like(x)
        m_out = torch.empty_like(m)
        args = (x.data_ptr(), m.data_ptr(), g.data_ptr(), lr.data_ptr(),
                x_out.data_ptr(), m_out.data_ptr())
    with torch.cuda.device(x.device):
        err = fn(*args, x.numel(), mu, wd, int(bool(nesterov)),
                 torch.cuda.current_stream().cuda_stream)
    if err:
        raise RuntimeError(f"momentum_update launch failed: CUDA error {err}")
    momentum_update.launches += 1
    return x_out, m_out


momentum_update.launches = 0     # kernel launches since the last reset
