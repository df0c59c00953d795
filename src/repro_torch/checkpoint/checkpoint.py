"""Checkpoints of named trees: one ``step_%08d/`` with ``{name}.npz`` and
``manifest.json``.

Port of ``src/repro/checkpoint/checkpoint.py``.  Leaves are keyed by their
path: the port's dotted leaf names, nested state joined by ``/``
(``"m/s0b0.gn1.scale"``, ``"mix/buf/..."``, ``"step"``).  A bf16 leaf is
stored as its u16 bits with its dtype in the manifest.  ``restore`` reads
into a template of the same structure (tensors, or meta tensors for the
shapes alone) and raises on a leaf whose shape differs.  Nothing here
needs a process group: ``SimTrainer``'s K-stacked trees and the sharded
trainer's (gathered to rank 0 first) are the same files.
"""
from __future__ import annotations

import json
import os
import re
from typing import Any, Dict

import numpy as np
import torch

__all__ = ["flatten_paths", "latest_step", "restore", "save",
           "unflatten_paths"]

_STEP_RE = re.compile(r"step_(\d+)")
# dtypes numpy cannot hold, stored as their bits
_VIEW_AS = {torch.bfloat16: (torch.int16, np.uint16)}


def flatten_paths(tree, prefix: str = "") -> Dict[str, Any]:
    """``{path: leaf}`` of a nested dict of tensors (a bare tensor is the
    one leaf ``""``)."""
    if not isinstance(tree, dict):
        return {prefix: tree}
    out = {}
    for k in sorted(tree):
        out.update(flatten_paths(tree[k], f"{prefix}/{k}" if prefix else k))
    return out


def unflatten_paths(template, leaves: Dict[str, Any], prefix: str = ""):
    """The inverse of :func:`flatten_paths` on ``template``'s structure."""
    if not isinstance(template, dict):
        return leaves[prefix]
    return {k: unflatten_paths(v, leaves, f"{prefix}/{k}" if prefix else k)
            for k, v in template.items()}


def _to_numpy(t: torch.Tensor):
    t = t.detach().cpu()
    if t.dtype in _VIEW_AS:
        view, np_dt = _VIEW_AS[t.dtype]
        return t.view(view).numpy().view(np_dt), str(t.dtype)
    return t.numpy(), str(t.dtype)


def _from_numpy(arr: np.ndarray, dtype: str) -> torch.Tensor:
    for tdt, (view, _np_dt) in _VIEW_AS.items():
        if dtype == str(tdt):
            return torch.from_numpy(arr.view(np.int16).copy()).view(tdt)
    return torch.from_numpy(np.array(arr))


def save(ckpt_dir: str, step: int, **trees) -> str:
    """``save(dir, step, params=..., opt_state=...)`` → the step's path."""
    path = os.path.join(ckpt_dir, f"step_{step:08d}")
    os.makedirs(path, exist_ok=True)
    manifest = {"step": int(step), "trees": {}, "dtypes": {}}
    for name, tree in trees.items():
        payload, dtypes = {}, {}
        for key, leaf in flatten_paths(tree).items():
            payload[key], dtypes[key] = _to_numpy(leaf)
        np.savez(os.path.join(path, f"{name}.npz"), **payload)
        manifest["trees"][name] = sorted(payload)
        manifest["dtypes"][name] = dtypes
    with open(os.path.join(path, "manifest.json"), "w") as f:
        json.dump(manifest, f)
    return path


def restore(ckpt_dir: str, step: int, templates: Dict[str, Any],
            device=None) -> Dict[str, Any]:
    """The named trees of ``step`` in the structure of ``templates``, each
    leaf on its template's device (``device`` where given: a meta
    template has none to give)."""
    path = os.path.join(ckpt_dir, f"step_{step:08d}")
    with open(os.path.join(path, "manifest.json")) as f:
        manifest = json.load(f)
    out = {}
    for name, template in templates.items():
        dtypes = manifest["dtypes"][name]
        with np.load(os.path.join(path, f"{name}.npz")) as data:
            leaves = {}
            for key, t in flatten_paths(template).items():
                leaf = _from_numpy(data[key], dtypes[key])
                if tuple(leaf.shape) != tuple(t.shape):
                    raise ValueError(
                        f"{name}/{key}: checkpoint leaf {tuple(leaf.shape)} "
                        f"!= template {tuple(t.shape)}")
                dev = device if device is not None else t.device
                leaves[key] = leaf.to(dev)
        out[name] = unflatten_paths(template, leaves)
    return out


def latest_step(ckpt_dir: str) -> int | None:
    if not os.path.isdir(ckpt_dir):
        return None
    steps = [int(m.group(1)) for d in os.listdir(ckpt_dir)
             if (m := _STEP_RE.fullmatch(d))]
    return max(steps) if steps else None
