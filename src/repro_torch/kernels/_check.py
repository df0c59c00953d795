"""Operand checks shared by the kernel wrappers: what a kernel does not
take raises here, before any pointer reaches C."""
from __future__ import annotations

import torch

from repro_torch.kernels import LANE


def check_matrix(t, name: str, like=None) -> None:
    """``t`` is a contiguous f32 ``(rows, LANE)`` tensor on a CPU or CUDA
    device — on ``like``'s device and of its shape when ``like`` is given —
    and, on a CUDA device, 16-byte aligned for the kernels' float4 access."""
    if not isinstance(t, torch.Tensor):
        raise TypeError(f"{name}: expected a torch.Tensor, got {type(t)}")
    if t.dtype != torch.float32:
        raise TypeError(f"{name}: dtype {t.dtype}, expected torch.float32")
    if t.dim() != 2 or t.shape[1] != LANE:
        raise ValueError(f"{name}: shape {tuple(t.shape)}, expected "
                         f"(rows, {LANE})")
    if t.device.type not in ("cpu", "cuda"):
        raise ValueError(f"{name}: unsupported device {t.device}")
    if like is not None:
        if t.device != like.device:
            raise ValueError(f"{name}: on {t.device}, expected {like.device}")
        if t.shape != like.shape:
            raise ValueError(f"{name}: shape {tuple(t.shape)} != "
                             f"{tuple(like.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: must be contiguous")
    if t.device.type == "cuda" and t.data_ptr() % 16:
        raise ValueError(f"{name}: data pointer not 16-byte aligned")
