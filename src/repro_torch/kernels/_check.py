"""Operand checks shared by the kernel wrappers: what a kernel does not
take raises here, before any pointer reaches C."""
from __future__ import annotations

import torch

from repro_torch.kernels import LANE

# the devices a wrapper takes: "cuda" launches the kernel; "cpu" and
# "meta" run the plain version (:func:`plain_route`)
DEVICES = ("cpu", "cuda", "meta")


def plain_route(t) -> bool:
    """Whether a wrapper runs the plain version on ``t``: on a CPU tensor,
    and on a meta tensor, where it only propagates shapes (the caller put
    the data there, so no card is hidden).  A CUDA tensor launches the
    kernel or raises."""
    return t.device.type in ("cpu", "meta")


def check_operand(t, name: str, dtype, shape, device) -> None:
    """``t`` is a contiguous ``dtype`` tensor of exactly ``shape`` on
    ``device`` (a CPU or CUDA device) and, on a CUDA device, 16-byte
    aligned for the kernels' vector access."""
    if not isinstance(t, torch.Tensor):
        raise TypeError(f"{name}: expected a torch.Tensor, got {type(t)}")
    if t.dtype != dtype:
        raise TypeError(f"{name}: dtype {t.dtype}, expected {dtype}")
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: shape {tuple(t.shape)}, expected "
                         f"{tuple(shape)}")
    if t.device.type not in DEVICES:
        raise ValueError(f"{name}: unsupported device {t.device}")
    if t.device != device:
        raise ValueError(f"{name}: on {t.device}, expected {device}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: must be contiguous")
    if t.device.type == "cuda" and t.data_ptr() % 16:
        raise ValueError(f"{name}: data pointer not 16-byte aligned")


def row_count(t, name: str) -> int:
    """The leading (row) extent of tensor ``t``, which must be ≥ 1."""
    if not isinstance(t, torch.Tensor):
        raise TypeError(f"{name}: expected a torch.Tensor, got {type(t)}")
    if t.dim() == 0 or t.shape[0] == 0:
        raise ValueError(f"{name}: shape {tuple(t.shape)} has no rows")
    return t.shape[0]


def check_matrix(t, name: str, like=None) -> None:
    """``t`` is a contiguous f32 ``(rows, LANE)`` tensor on a CPU, CUDA or
    meta device — on ``like``'s device and of its shape when ``like`` is
    given — and, on a CUDA device, 16-byte aligned for the kernels' float4
    access."""
    if not isinstance(t, torch.Tensor):
        raise TypeError(f"{name}: expected a torch.Tensor, got {type(t)}")
    if like is not None:
        check_operand(t, name, torch.float32, like.shape, like.device)
    else:
        rows = t.shape[0] if t.dim() == 2 else -1
        check_operand(t, name, torch.float32, (rows, LANE), t.device)
