"""Gossip communication: the dense K-worker simulation backend.

Port of ``src/repro/core/gossip.py:67-373`` and ``:840-875``.
:class:`DenseComm` keeps every leaf worker-stacked (leading dim K) and
mixes ``x⁽ᵏ⁾ ← Σⱼ w_kj x⁽ʲ⁾`` either as ``W @ flat`` over the worker dim
(:meth:`DenseComm.mix`, the tree path), as shifted views of the worker
grid (:meth:`DenseComm._roll`, :meth:`DenseComm.shift_views`) or, on the
kernel path, through the fused AXPY kernel, which the optimizer hands the
topology's shifts to read the views in place.  Built from a
:class:`TopologySchedule`, it stacks the schedule's ``(T, K, K)`` weights
on its device and ``mix(tree, r)`` selects round ``r``'s by ``r mod T``,
where ``r`` may be a 0-d device tensor: no host sync.  With a
:class:`MembershipSchedule` (elastic membership) it stacks the masked
matrix of every round of the joint cycle, ``lcm(T, M)`` rounds, and the
``(cycle, K)`` active masks, selected the same way; a round where every
worker is active uses the topology's own W, bit for bit.

Not in this slice, and refused: the one-round-stale mix of overlapped
rounds, :meth:`DenseComm.stale_mix` (ROADMAP queue A item 9), the bf16
wire (item 10) and the sharded backend with its membership programs
(item 12).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.core.topology import (MembershipSchedule, Topology,
                                       TopologySchedule, active_edge_count,
                                       masked_matrix)
from repro_torch.tree import tree_leaves, tree_map

__all__ = ["CommBackend", "DenseComm", "gossip_bytes_per_round",
           "select_round", "worker_mask_like"]

ShiftKey = Tuple[int, int]  # (topology axis, shift)


def worker_mask_like(mask, leaf):
    """A (K,) worker mask reshaped to broadcast against a worker-stacked
    leaf of shape (K, ...)."""
    return mask.reshape((mask.shape[0],) + (1,) * (leaf.dim() - 1))


def select_round(table: torch.Tensor, r, what: str,
                 call: str = "mix(tree, r=...)") -> torch.Tensor:
    """Row ``r mod len(table)`` of a per-round table; a 0-d tensor ``r``
    selects on the table's device (no host sync)."""
    n = table.shape[0]
    if n == 1:
        return table[0]
    if r is None:
        raise ValueError(f"DenseComm with {what} needs the round index: "
                         f"{call}")
    if isinstance(r, torch.Tensor):
        idx = torch.remainder(r.to(table.device, torch.long), n)
        return torch.index_select(table, 0, idx.reshape(1))[0]
    return table[int(r) % n]


class CommBackend:
    """What an optimizer needs of a gossip backend.  ``topology`` is round
    0's (shapes, worker count); ``topology_at(r)`` is round ``r``'s."""
    topology: Topology
    schedule: Optional[TopologySchedule] = None
    membership: Optional[MembershipSchedule] = None
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
        """Joint period of the topology schedule and the membership
        schedule: the rounds after which both the graph and the liveness
        repeat.  Byte accounting and the stacked matrices cycle over
        this."""
        M = self.membership.period if self.membership is not None else 1
        return math.lcm(self.period, M)

    def topology_at(self, r: int) -> Topology:
        """Topology of round ``r`` (a Python int; wraps modulo the
        period)."""
        if self.schedule is not None:
            return self.schedule.at(r)
        return self.topology

    def active_at(self, r: int) -> np.ndarray:
        """(K,) bool: workers exchanging in round ``r`` (all True without
        a membership schedule)."""
        if self.membership is None:
            return np.ones(self.topology.n_workers, dtype=bool)
        return self.membership.active_at(r)

    def effective_matrix(self, r: int) -> np.ndarray:
        """The K×K mixing matrix of round ``r`` with the membership mask
        applied (float64, on the host)."""
        top = self.topology_at(r)
        act = self.active_at(r)
        if act.all():
            return np.asarray(top.W)
        return masked_matrix(top, act)

    def edges_per_worker(self, r: int = 0):
        """Mean directed exchanges per worker in round ``r``: the degree
        (an int) without membership or with every worker active, else
        ``active_edge_count / K`` (a float; dead edges ship nothing)."""
        top = self.topology_at(r)
        act = self.active_at(r)
        if self.membership is None or act.all():
            return top.degree
        return active_edge_count(top, act) / top.n_workers

    def mix(self, tree, r=None):
        raise NotImplementedError

    def stale_mix(self, tree, r=None):
        """The overlapped round's one-round-stale mix, under the delivery
        round's liveness: not ported (ROADMAP queue A item 9)."""
        raise NotImplementedError(
            "stale_mix (overlapped rounds) is ROADMAP queue A item 9")

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
    ``device``.  Takes a ``Topology`` or a ``TopologySchedule``, and
    optionally a ``MembershipSchedule`` over the same K."""

    topology: Topology  # or a TopologySchedule at construction
    membership: Optional[MembershipSchedule] = None
    wire_dtype: str = "float32"
    device: object = "cuda"

    def __post_init__(self):
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
        self._Wm = self._act = None
        if self.membership is not None:
            self.membership.validate()
            if self.membership.n_workers != self.topology.n_workers:
                raise ValueError(
                    f"membership K={self.membership.n_workers} != topology "
                    f"K={self.topology.n_workers}")
            # every round of the joint cycle, masked; an all-active round
            # keeps the topology's own W
            rounds = range(self.round_cycle)
            self._Wm = torch.tensor(
                np.stack([self.effective_matrix(r) for r in rounds]),
                dtype=torch.float32, device=self.device)
            self._act = torch.tensor(
                np.stack([self.active_at(r) for r in rounds]),
                device=self.device)

    def _W_at(self, r):
        if self.membership is not None:
            return select_round(self._Wm, r, "a MembershipSchedule")
        if self.period == 1:
            return self._W
        return select_round(self._Ws, r, "a TopologySchedule")

    def active_mask(self, r):
        """(K,) bool of round ``r``'s active workers on the device (``r`` an
        int or a 0-d tensor); None without membership.  Optimizers pin a
        straggler's auxiliary state with it (MT's correction)."""
        if self.membership is None:
            return None
        return select_round(self._act, r, "a MembershipSchedule",
                            "active_mask(r=...)")

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
    a compressed wire.  Under a membership schedule dead edges ship
    nothing: the multiplier is the round's active-edge count over K (a
    float)."""
    deg = backend.topology_at(r).degree
    total_elems = sum(int(np.prod(tuple(l.shape))) for l in tree_leaves(tree))
    if backend.membership is not None:
        epw = backend.edges_per_worker(r)
        if bits_per_element is None:
            return epw * _wire_leaf_bytes(tree, backend)
        return float(epw * total_elems * bits_per_element / 8.0)
    if bits_per_element is None:
        return deg * _wire_leaf_bytes(tree, backend)
    return int(deg * total_elems * bits_per_element / 8.0)
