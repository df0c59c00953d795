"""Elastic K→K′ restores and revival warm-starts.

Port of ``src/repro/checkpoint/elastic.py``.  A checkpoint
(:mod:`repro_torch.checkpoint.checkpoint`) holds worker-stacked trees for
a fleet of K workers; this module carries it to another fleet size and
revives workers inside a fleet:

* :func:`restore_elastic`: a checkpoint written by K workers into K′-worker
  templates.  Survivors (slots < min(K, K′)) keep their own slices bit for
  bit; joiners take a live donor's params and whole optimizer state
  (:func:`donor_map`).  With K′ = K it is :func:`checkpoint.restore`.
* :func:`warm_start_worker`: in-fleet revival, a live donor's slot copied
  over a rejoining worker's before its first round back.

CPD-SGDM's per-neighbour ``xhat_nbrs`` copies (the sharded backend's) are
re-derived from the re-partitioned x̂ (:func:`_derive_nbrs`): the commit
protocol keeps every copy equal to its owner's x̂ at a round boundary.
Trees are nested dicts of tensors; a leaf with a leading dim of K is
worker-stacked, any other (the step counter, the staleness phase) passes
through.
"""
from __future__ import annotations

import os
import re
from typing import Any, Dict, Optional

import numpy as np
import torch

from repro_torch.tree import tree_leaves

__all__ = ["donor_map", "pick_donor", "repartition", "restore_elastic",
           "warm_start_worker"]

_NBR_KEY_RE = re.compile(r"ax(\d+)_sh([+-]\d+)")


def _map(f, tree):
    """``f`` over the leaves of a nested dict (or a bare tensor)."""
    if isinstance(tree, dict):
        return {k: _map(f, v) for k, v in tree.items()}
    return f(tree)


def donor_map(old_k: int, new_k: int) -> np.ndarray:
    """(new_k,) source slot per new slot: the identity for survivors, the
    wrapped neighbour slices for joiners (slot K+j warm-starts from
    worker j)."""
    return np.arange(new_k) % old_k


def pick_donor(live, joiner: int) -> int:
    """The nearest live worker to ``joiner`` on the ring order, the next
    one up first: the donor a rejoining worker warm-starts from."""
    live = np.asarray(live, dtype=bool)
    K = live.shape[0]
    for d in range(1, K):
        for cand in ((joiner + d) % K, (joiner - d) % K):
            if live[cand]:
                return int(cand)
    raise ValueError("no live donor in the fleet")


def _reindex(tree, k_from: int, donors: np.ndarray):
    """Every worker-stacked leaf (leading dim ``k_from``) re-indexed by
    ``donors``; other leaves pass through."""
    def f(leaf):
        if leaf.dim() >= 1 and leaf.shape[0] == k_from:
            idx = torch.as_tensor(np.asarray(donors), dtype=torch.long,
                                  device=leaf.device)
            return torch.index_select(leaf, 0, idx)
        return leaf
    return _map(f, tree)


def repartition(tree, old_k: int, new_k: int,
                donors: Optional[np.ndarray] = None):
    """A worker-stacked tree from ``old_k`` to ``new_k`` slots
    (:func:`donor_map` by default).  ``xhat_nbrs`` is the caller's to
    re-derive (:func:`restore_elastic` does)."""
    if donors is None:
        donors = donor_map(old_k, new_k)
    return _reindex(tree, old_k, donors)


def _derive_nbrs(xhat, keys, new_k: int) -> Dict[str, Any]:
    """The per-shift neighbour copies from the canonical x̂:
    ``copy[(ax, sh)][w] = x̂[(w + sh) mod K′]``."""
    nbrs = {}
    for key in keys:
        m = _NBR_KEY_RE.fullmatch(key)
        if m is None:
            raise ValueError(f"unrecognized xhat_nbrs key {key!r}")
        sh = int(m.group(2))
        recv = (np.arange(new_k) + sh) % new_k
        nbrs[key] = _map(lambda h: torch.index_select(
            h, 0, torch.as_tensor(recv, device=h.device)), xhat)
    return nbrs


def _resize_worker_dim(tree, k_from: int, k_to: int):
    """The template with its worker dim resized, as meta tensors (shapes
    and dtypes, no data)."""
    def f(leaf):
        shape = tuple(leaf.shape)
        if len(shape) >= 1 and shape[0] == k_from:
            shape = (k_to,) + shape[1:]
        return torch.empty(shape, dtype=leaf.dtype, device="meta")
    return _map(f, tree)


def _peek_worker_count(ckpt_dir: str, step: int) -> int:
    """The leading dim of the checkpoint's params: the fleet size that
    wrote it."""
    path = os.path.join(ckpt_dir, f"step_{step:08d}", "params.npz")
    with np.load(path) as data:
        return int(data[sorted(data.files)[0]].shape[0])


def restore_elastic(ckpt_dir: str, step: int, *, params_template,
                    state_template, comm=None, device=None) -> Dict[str, Any]:
    """``{"params", "opt_state"}`` of a checkpoint written by an old fleet,
    in (possibly differently sized) new-fleet templates (K′-stacked;
    ``device`` for meta templates).

    Same size: exactly :func:`checkpoint.restore`.  K→K′: every
    worker-stacked leaf re-indexed through :func:`donor_map`, the step
    counter unchanged (round, schedule and membership phase derive from
    it), and ``xhat_nbrs`` re-derived from the re-partitioned x̂ under the
    new fleet's shifts (``comm``, the new fleet's backend, is needed then:
    the old fleet's copy keys come from the same topology family at the
    old size)."""
    from repro_torch.checkpoint import checkpoint as ckpt

    new_k = tree_leaves(params_template)[0].shape[0]
    old_k = _peek_worker_count(ckpt_dir, step)
    if old_k == new_k:
        return ckpt.restore(ckpt_dir, step, {
            "params": params_template, "opt_state": state_template},
            device=device)

    donors = donor_map(old_k, new_k)
    old_params_t = _resize_worker_dim(params_template, new_k, old_k)
    old_state_t = {}
    for name, sub in state_template.items():
        if name == "xhat_nbrs":
            if comm is None:
                raise ValueError(
                    "restore_elastic: re-partitioning xhat_nbrs needs the "
                    "new fleet's comm backend (comm=...)")
            from repro_torch.core.topology import make_topology
            top = comm.topology
            if len(top.axis_sizes) != 1:
                raise ValueError(
                    "elastic re-partitioning needs a single worker axis")
            old_top = make_topology(top.name, (old_k,))
            proto = next(iter(sub.values()))
            old_state_t[name] = {
                f"ax{ax}_sh{sh:+d}": _resize_worker_dim(proto, new_k, old_k)
                for (ax, sh, _w) in old_top.shifts if sh != 0}
        else:
            old_state_t[name] = _resize_worker_dim(sub, new_k, old_k)
    dev = device if device is not None else \
        tree_leaves(params_template)[0].device
    restored = ckpt.restore(ckpt_dir, step, {
        "params": old_params_t, "opt_state": old_state_t}, device=dev)
    params = _reindex(restored["params"], old_k, donors)
    state = {name: _reindex(sub, old_k, donors)
             for name, sub in restored["opt_state"].items()
             if name != "xhat_nbrs"}     # re-derived below, from the new x̂
    if "xhat_nbrs" in state_template:
        state["xhat_nbrs"] = _derive_nbrs(
            state["xhat"], sorted(state_template["xhat_nbrs"]), new_k)
    return {"params": params, "opt_state": state}


def warm_start_worker(params, state, *, joiner: int, donor: int):
    """``(params, state)`` with ``donor``'s slot copied over ``joiner``'s in
    every worker-stacked leaf: params and the whole optimizer state
    (momentum, x̂, the tracking correction, QG's buffers, an overlapped
    round's in-flight payload).  New tensors are returned; the caller's are
    not written.  Leaves without a leading worker dim (the step counter,
    the staleness phase) are passed through; ``xhat_nbrs``, where present,
    is re-derived from the patched x̂."""
    K = tree_leaves(params)[0].shape[0]

    def cp(leaf):
        if isinstance(leaf, torch.Tensor) and leaf.dim() >= 1 \
                and leaf.shape[0] == K:
            out = leaf.clone()
            out[joiner] = leaf[donor]
            return out
        return leaf

    new_state = {k: _map(cp, v) for k, v in state.items()
                 if k != "xhat_nbrs"}
    if "xhat_nbrs" in state:
        new_state["xhat_nbrs"] = _derive_nbrs(
            new_state["xhat"], sorted(state["xhat_nbrs"]), K)
    return _map(cp, params), new_state
