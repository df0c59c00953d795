"""Revival warm-starts of elastic membership on the dense backend.

Port of ``pick_donor`` and ``warm_start_worker``
(``src/repro/checkpoint/elastic.py:48-57`` and ``:179-202``).  A worker
that rejoins the fleet takes a live donor's params and complete optimizer
state before its first round back, so its first exchange carries a live
model and not its stale shard from before the kill.

The dense backend keeps one stacked x̂ and no per-neighbour ``xhat_nbrs``
copies, so there is nothing to re-derive here.  Not ported:
``restore_elastic``, ``donor_map``, ``repartition`` and ``_derive_nbrs``,
which read and write checkpoints of a K-worker fleet into a K′-worker one
and re-derive the sharded backend's copies (ROADMAP queue A item 12).
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.tree import tree_leaves, tree_map

__all__ = ["pick_donor", "warm_start_worker"]


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


def warm_start_worker(params, state, *, joiner: int, donor: int):
    """``(params, state)`` with ``donor``'s slot copied over ``joiner``'s in
    every worker-stacked leaf: params and the whole optimizer state
    (momentum, x̂, the tracking correction, QG's buffers, an overlapped
    round's in-flight payload).  New tensors are returned; the caller's are
    not written.  Leaves without a leading worker dim (the step counter,
    the staleness phase) are passed through."""
    K = tree_leaves(params)[0].shape[0]

    def cp(leaf):
        if isinstance(leaf, dict):        # a nested tree: state["mix"]
            return {k: cp(v) for k, v in leaf.items()}
        if isinstance(leaf, torch.Tensor) and leaf.dim() >= 1 \
                and leaf.shape[0] == K:
            out = leaf.clone()
            out[joiner] = leaf[donor]
            return out
        return leaf

    return tree_map(cp, params), cp(state)
