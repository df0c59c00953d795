"""Roofline terms and the training-FLOPs rule.

Port of ``src/repro/launch/hlo_analysis.py:25-40``.  The reference's terms
are taken on its TPU's ``HW``; the port's on the H100's
(:class:`repro_torch.launch.mesh.HW`, data-sheet peaks), or on a ``hw``
passed in.  The collective traffic comes from the recorder
(:mod:`repro_torch.analysis.collectives`), not from HLO text.
"""
from __future__ import annotations

from typing import Dict

from repro_torch.launch.mesh import HW

__all__ = ["model_flops", "roofline_terms"]


def roofline_terms(flops_per_device: float, bytes_per_device: float,
                   wire_bytes_per_device: float, hw=HW) -> Dict[str, float]:
    """The three roofline terms, in seconds a call, and the largest."""
    compute = flops_per_device / hw.PEAK_FLOPS_BF16
    memory = bytes_per_device / hw.HBM_BW
    collective = wire_bytes_per_device / hw.ICI_BW
    dom = max(("compute", compute), ("memory", memory),
              ("collective", collective), key=lambda kv: kv[1])[0]
    return {"compute_s": compute, "memory_s": memory,
            "collective_s": collective, "dominant": dom}


def model_flops(n_active_params: float, tokens: float, kind: str) -> float:
    """6·N·D for training, 2·N·D for inference forward passes."""
    factor = 6.0 if kind == "train" else 2.0
    return factor * n_active_params * tokens
