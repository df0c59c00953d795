"""Params and optimizer state from the reference package into the port's
layout.

The reference keeps params as nested dicts of arrays; the port keeps a flat
dict named by key path (:mod:`repro_torch.tree`).  This module takes the
reference's trees as numpy arrays (callers convert with ``np.asarray``),
so it imports nothing of the reference.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.tree import leaf_order

__all__ = ["params_from_reference", "state_from_reference"]


def _dotted(tree, prefix: str = "") -> dict:
    """Nested dicts → ``{"a.b.c": leaf}``."""
    out = {}
    for k, v in tree.items():
        name = f"{prefix}{k}"
        if isinstance(v, dict):
            out.update(_dotted(v, name + "."))
        else:
            out[name] = v
    return out


def params_from_reference(tree_of_numpy: dict, device="cuda") -> dict:
    """The port's param dict for the reference's nested ``tree_of_numpy``
    (worker-stacked or not): same names, shapes, layouts (HWIO convs) and
    leaf order, values copied exactly, on ``device``."""
    device = resolve_device(device)
    flat = _dotted(tree_of_numpy)
    return {name: torch.as_tensor(np.array(flat[name]), device=device)
            for name in leaf_order(flat)}


def state_from_reference(state_of_numpy: dict, device="cuda") -> dict:
    """The port's optimizer state for the reference's PD-/CPD-SGDM state
    (``m``, ``step`` and, for CPD-SGDM, ``xhat``) as numpy: the per-element
    trees as :func:`params_from_reference` converts them, ``step`` a 0-d
    int32 tensor, on ``device``."""
    device = resolve_device(device)
    out = {}
    for key in ("m", "xhat"):
        if key in state_of_numpy:
            out[key] = params_from_reference(state_of_numpy[key], device)
    out["step"] = torch.tensor(int(np.asarray(state_of_numpy["step"])),
                               dtype=torch.int32, device=device)
    return out
