"""PyTorch port of the PD-SGDM reproduction, for NVIDIA Hopper GPUs.

The JAX package ``repro`` is the reference; this package mirrors it module
by module (``repro_torch.core.pdsgdm`` ↔ ``repro.core.pdsgdm``) and imports
nothing of it.  Parameter trees are flat ``{dotted name: tensor}`` dicts
(:mod:`repro_torch.tree`); the hot path runs on the flatten-once
``(rows, 1024)`` kernel layout through hand-written CUDA kernels
(:mod:`repro_torch.kernels`).

Entry points take an explicit ``device`` that defaults to ``"cuda"`` and
raise when no card is present; pass ``device="cpu"`` to run the plain
PyTorch versions of the kernels instead.
"""
from __future__ import annotations

import torch

__all__ = ["resolve_device"]


def resolve_device(device="cuda") -> torch.device:
    """``torch.device(device)``, raising when a CUDA device is asked for
    and none is present (never a silent move to the CPU)."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {str(dev)!r} requested but torch.cuda.is_available() is "
            "False; pass device='cpu' to run the plain PyTorch path")
    return dev
