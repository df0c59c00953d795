"""Learning-rate schedules (multiplicative factors; the peak LR lives in the
optimizer config).  Port of ``src/repro/core/schedules.py``.

Each schedule maps the 0-d int32 step counter, a tensor on the device, to a
0-d f32 factor on the same device without a host sync.
"""
from __future__ import annotations

import math
from typing import Sequence

import torch

__all__ = ["constant", "step_decay", "warmup_cosine"]


def constant():
    return lambda step: torch.ones((), dtype=torch.float32,
                                   device=step.device)


def step_decay(milestones: Sequence[int], factor: float = 0.1):
    """×factor at each milestone step (paper: epochs {150,225} / {30,60,80})."""
    ms = sorted(int(m) for m in milestones)

    def fn(step):
        n = sum((step >= m).to(torch.float32) for m in ms)
        base = torch.full((), factor, dtype=torch.float32, device=step.device)
        return torch.pow(base, n)

    return fn


def warmup_cosine(warmup_steps: int, total_steps: int, min_factor: float = 0.1):
    w = float(max(warmup_steps, 1))
    span = max(total_steps - w, 1.0)

    def fn(step):
        step = step.to(torch.float32)
        warm = step / w
        t = torch.clamp((step - w) / span, 0.0, 1.0)
        cos = min_factor + (1 - min_factor) * 0.5 * (1 + torch.cos(math.pi * t))
        return torch.where(step < w, warm, cos)

    return fn
