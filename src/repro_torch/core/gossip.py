"""Gossip communication: the dense K-worker simulation backend.

Port of ``src/repro/core/gossip.py:84-373`` and ``:840-875``.
:class:`DenseComm` keeps every leaf worker-stacked (leading dim K) and
mixes ``x⁽ᵏ⁾ ← Σⱼ w_kj x⁽ʲ⁾`` either as ``W @ flat`` over the worker dim
(:meth:`DenseComm.mix`, the tree path), as shifted views of the worker
grid (:meth:`DenseComm._roll`, :meth:`DenseComm.shift_views`) or, on the
kernel path, through the fused AXPY kernel, which the optimizer hands the
topology's shifts to read the views in place.  Built from a
:class:`TopologySchedule`, it stacks the schedule's ``(T, K, K)`` weights
on its device and ``mix(tree, r)`` selects round ``r``'s by ``r mod T``,
where ``r`` may be a 0-d device tensor: no host sync.

Not in this slice, and refused at construction: membership schedules
(ROADMAP queue A item 7), the bf16 wire (queue A item 10) and the sharded
backend (queue A item 12).
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.core.topology import Topology, TopologySchedule
from repro_torch.tree import tree_leaves, tree_map

__all__ = ["CommBackend", "DenseComm", "gossip_bytes_per_round"]

ShiftKey = Tuple[int, int]  # (topology axis, shift)


class CommBackend:
    """What an optimizer needs of a gossip backend.  ``topology`` is round
    0's (shapes, worker count); ``topology_at(r)`` is round ``r``'s."""
    topology: Topology
    schedule: Optional[TopologySchedule] = None
    membership: Optional[object] = None
    wire_dtype: str = "float32"

    @property
    def wire_itemsize(self) -> int:
        """Bytes per element of the uncompressed gossip payload."""
        return 2 if self.wire_dtype == "bfloat16" else 4

    @property
    def period(self) -> int:
        """Schedule period T (1 for a static topology)."""
        return self.schedule.period if self.schedule is not None else 1

    @property
    def round_cycle(self) -> int:
        """Rounds after which the graph repeats: byte accounting cycles
        over this.  (The reference's joint period with a membership
        schedule waits for ROADMAP queue A item 7.)"""
        return self.period

    def topology_at(self, r: int) -> Topology:
        """Topology of round ``r`` (a Python int; wraps modulo the
        period)."""
        if self.schedule is not None:
            return self.schedule.at(r)
        return self.topology

    def mix(self, tree, r=None):
        raise NotImplementedError

    def shift_views(self, tree) -> Dict[ShiftKey, object]:
        raise NotImplementedError

    def weights(self) -> Dict[ShiftKey, float]:
        return {(ax, sh): w for (ax, sh, w) in self.topology.shifts}

    def nonself_shifts(self):
        return [(ax, sh, w) for (ax, sh, w) in self.topology.shifts if sh != 0]

    def self_weight(self) -> float:
        return float(sum(w for (_, sh, w) in self.topology.shifts if sh == 0))

    def _resolve(self, first):
        """A schedule sets both the schedule and the round-0 topology."""
        if isinstance(first, TopologySchedule):
            self.schedule = first
            self.topology = first.at(0)
        else:
            self.schedule = None
            self.topology = first


@dataclasses.dataclass
class DenseComm(CommBackend):
    """Simulation backend: leaves are worker-stacked, leading dim K, on
    ``device``.  Takes a ``Topology`` or a ``TopologySchedule``."""

    topology: Topology  # or a TopologySchedule at construction
    membership: Optional[object] = None
    wire_dtype: str = "float32"
    device: object = "cuda"

    def __post_init__(self):
        if self.membership is not None:
            raise NotImplementedError(
                "membership schedules are ROADMAP queue A item 7")
        if self.wire_dtype == "bfloat16":
            raise NotImplementedError(
                "the bf16 gossip wire is ROADMAP queue A item 10")
        if self.wire_dtype != "float32":
            raise ValueError(f"wire_dtype {self.wire_dtype!r} not in "
                             "('float32', 'bfloat16')")
        self._resolve(self.topology)
        self.device = resolve_device(self.device)
        self._W = torch.tensor(self.topology.W, dtype=torch.float32,
                               device=self.device)
        self._Ws = (torch.tensor(self.schedule.stacked_W(),
                                 dtype=torch.float32, device=self.device)
                    if self.schedule is not None else None)

    def _W_at(self, r):
        if self.period == 1:
            return self._W
        if r is None:
            raise ValueError(
                "DenseComm with a TopologySchedule needs the round index: "
                "mix(tree, r=...)")
        if isinstance(r, torch.Tensor):     # selected on the device
            idx = torch.remainder(r.to(self.device, torch.long), self.period)
            return torch.index_select(self._Ws, 0, idx.reshape(1))[0]
        return self._Ws[int(r) % self.period]

    def mix(self, tree, r=None):
        """Σⱼ w_kj x⁽ʲ⁾ over the worker dim of every leaf, with round
        ``r``'s W (an int or a 0-d tensor; a static graph ignores it)."""
        return self._apply_W(self._W_at(r), tree)

    def _apply_W(self, W, tree):
        K = self.topology.n_workers

        def _mix(leaf):
            if leaf.shape[0] != K:
                raise ValueError(f"leaf worker dim {leaf.shape[0]} != K={K}")
            flat = leaf.reshape(K, -1).to(torch.float32)
            return (W @ flat).to(leaf.dtype).reshape(leaf.shape)

        return tree_map(_mix, tree)

    def _roll(self, leaf, axis: int, shift: int):
        """The view where worker k sees worker (k+shift)'s value along
        ``axis`` of the worker grid."""
        grid = tuple(self.topology.axis_sizes)
        g = leaf.reshape(grid + tuple(leaf.shape[1:]))
        g = torch.roll(g, -shift, dims=axis)
        return g.reshape(leaf.shape)

    def shift_views(self, tree) -> Dict[ShiftKey, object]:
        return {(ax, sh): tree_map(lambda leaf: self._roll(leaf, ax, sh), tree)
                for (ax, sh, _w) in self.nonself_shifts()}


def _wire_leaf_bytes(tree, backend: CommBackend) -> int:
    """Σ leaf bytes as they ship: the leaf dtype, narrowed to the backend's
    wire dtype when that is narrower."""
    wi = backend.wire_itemsize
    return sum(int(np.prod(tuple(l.shape))) * min(l.dtype.itemsize, wi)
               for l in tree_leaves(tree))


def gossip_bytes_per_round(tree, backend: CommBackend,
                           bits_per_element: float | None = None,
                           r: int = 0) -> int:
    """Per-worker bytes sent in gossip round ``r``: the degree × Σ leaf
    bytes at the wire dtype, or × elements × ``bits_per_element`` / 8 for
    a compressed wire."""
    deg = backend.topology_at(r).degree
    if bits_per_element is None:
        return deg * _wire_leaf_bytes(tree, backend)
    total_elems = sum(int(np.prod(tuple(l.shape))) for l in tree_leaves(tree))
    return int(deg * total_elems * bits_per_element / 8.0)
