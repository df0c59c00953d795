"""Gossip communication: the dense K-worker simulation backend.

Port of ``src/repro/core/gossip.py:67-373`` and ``:840-920``.
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

* **Overlapped rounds**: :meth:`DenseComm.stale_mix` mixes a one-round-
  stale payload with the payload round's topology masked by the delivery
  round's liveness (:meth:`CommBackend.effective_stale_matrix`).
* **The bf16 wire** (``wire_dtype="bfloat16"``): each worker keeps its own
  value in f32 and receives its neighbours' rounded to bf16,
  ``diag·x + (W − diag)·bf16(x)``, summed in f32.
* **Hierarchical graphs** without membership mix in their factored form
  (:meth:`DenseComm._apply_hier`): the exact in-node mean, the inter-node
  factor on the node means (the bf16 point on that slow wire), the result
  broadcast in-node; bytes per level are :func:`hier_bytes_per_round`.

Not in this module: the sharded backend, its hierarchical comm and its
membership programs (ROADMAP queue A item 12).
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
                                       hierarchical_inter_shifts,
                                       hierarchical_self_weight,
                                       masked_matrix)
from repro_torch.tree import tree_leaves, tree_map

__all__ = ["CommBackend", "DenseComm", "gossip_bytes_per_round",
           "hier_bytes_per_round", "select_round", "worker_mask_like"]

ShiftKey = Tuple[int, int]  # (topology axis, shift)

# dtypes the gossip wire ships the uncompressed payload in
_WIRE_DTYPES = ("float32", "bfloat16")


def worker_mask_like(mask, leaf):
    """A (K,) worker mask reshaped to broadcast against a worker-stacked
    leaf of shape (K, ...)."""
    return mask.reshape((mask.shape[0],) + (1,) * (leaf.dim() - 1))


def _inter_factor(top: Topology) -> np.ndarray:
    """The (n_nodes, n_nodes) inter-level factor R of a hierarchical
    topology, ``W = R ⊗ (1/m)11ᵀ``, rebuilt from its axis-0 shifts."""
    n = int(top.axis_sizes[0])
    R = np.eye(n) * hierarchical_self_weight(top)
    for (sh, w) in hierarchical_inter_shifts(top):
        for i in range(n):
            R[i, (i + sh) % n] += w
    return R


def bf16_round_trip(x: torch.Tensor) -> torch.Tensor:
    """``x`` as the bf16 wire delivers it: rounded to bf16 (to nearest
    even) and widened back to f32."""
    return x.to(torch.bfloat16).to(torch.float32)


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

    def effective_stale_matrix(self, r: int) -> np.ndarray:
        """The K×K matrix of the overlapped delivery of round ``r``'s
        payload: round ``r``'s topology masked by the liveness of the
        delivery round ``r+1`` (a payload from a worker that died in
        flight is dropped and its mass returns to the receivers' self
        weight).  :meth:`effective_matrix` without membership."""
        top = self.topology_at(r)
        act = self.active_at(r + 1)
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
        """Mix of a one-round-stale snapshot under round ``r``'s topology
        and the delivery round's (``r+1``) liveness
        (:meth:`effective_stale_matrix`); :meth:`mix` without
        membership."""
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
    ``device``.  Takes a ``Topology`` or a ``TopologySchedule``, and
    optionally a ``MembershipSchedule`` over the same K."""

    topology: Topology  # or a TopologySchedule at construction
    membership: Optional[MembershipSchedule] = None
    wire_dtype: str = "float32"
    device: object = "cuda"

    def __post_init__(self):
        if self.wire_dtype not in _WIRE_DTYPES:
            raise ValueError(
                f"wire_dtype {self.wire_dtype!r} not in {_WIRE_DTYPES}")
        self._resolve(self.topology)
        self.device = resolve_device(self.device)
        self._W = torch.tensor(self.topology.W, dtype=torch.float32,
                               device=self.device)
        self._Ws = (torch.tensor(self.schedule.stacked_W(),
                                 dtype=torch.float32, device=self.device)
                    if self.schedule is not None else None)
        # Hierarchical rounds without membership mix in the factored form:
        # the exact in-node mean, then the (n, n) inter factor of each
        # round of the schedule, stacked
        tops = (self.schedule.topologies if self.schedule is not None
                else (self.topology,))
        self._hier_m, self._hier_R = 0, None
        if (all(t.name == "hierarchical" for t in tops)
                and self.membership is None):
            self._hier_m = int(self.topology.axis_sizes[1])
            self._hier_R = torch.tensor(
                np.stack([_inter_factor(t) for t in tops]),
                dtype=torch.float32, device=self.device)
        self._Wm = self._act = self._Wov = None
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
            # the overlapped delivery: round r's payload under round r+1's
            # liveness, over the same cycle
            self._Wov = torch.tensor(
                np.stack([self.effective_stale_matrix(r) for r in rounds]),
                dtype=torch.float32, device=self.device)

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
        ``r``'s W (an int or a 0-d tensor; a static graph ignores it); a
        hierarchical graph without membership in its factored form."""
        if self._hier_R is not None:
            return self._apply_hier(
                select_round(self._hier_R, r, "a TopologySchedule"), tree)
        return self._apply_W(self._W_at(r), tree)

    def stale_mix(self, tree, r=None):
        if self.membership is None:
            return self.mix(tree, r=r)
        return self._apply_W(select_round(self._Wov, r, "a MembershipSchedule",
                                          "stale_mix(tree, r=...)"), tree)

    def _check_workers(self, leaf):
        K = self.topology.n_workers
        if leaf.shape[0] != K:
            raise ValueError(f"leaf worker dim {leaf.shape[0]} != K={K}")

    def _wire_mix(self, W, x):
        """``W @ x`` over the worker dim of the f32 (K, n) ``x``; on the
        bf16 wire each row keeps its own term in f32 and takes its
        neighbours' terms from the bf16 round trip."""
        if self.wire_dtype != "bfloat16":
            return W @ x
        diag = torch.diagonal(W)
        return diag[:, None] * x + (W - torch.diag(diag)) @ bf16_round_trip(x)

    def _apply_W(self, W, tree):
        def _mix(leaf):
            self._check_workers(leaf)
            flat = leaf.reshape(leaf.shape[0], -1).to(torch.float32)
            return self._wire_mix(W, flat).to(leaf.dtype).reshape(leaf.shape)

        return tree_map(_mix, tree)

    def _apply_hier(self, R, tree):
        """The factored hierarchical round: the exact in-node mean, the
        inter factor ``R`` on the node means (the bf16 point on this slow
        wire), the result broadcast to every worker of its node."""
        m = self._hier_m

        def _mix(leaf):
            self._check_workers(leaf)
            flat = leaf.reshape(leaf.shape[0] // m, m, -1).to(torch.float32)
            mixed = self._wire_mix(R, flat.mean(dim=1))
            return (mixed[:, None, :].expand(flat.shape).to(leaf.dtype)
                    .reshape(leaf.shape))

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
    float).  A hierarchical graph without membership is charged its
    slow-link level only (:func:`hier_bytes_per_round`'s ``"inter"``)."""
    top = backend.topology_at(r)
    if top.name == "hierarchical" and backend.membership is None:
        return hier_bytes_per_round(tree, backend, r=r)["inter"]
    deg = top.degree
    total_elems = sum(int(np.prod(tuple(l.shape))) for l in tree_leaves(tree))
    if backend.membership is not None:
        epw = backend.edges_per_worker(r)
        if bits_per_element is None:
            return epw * _wire_leaf_bytes(tree, backend)
        return float(epw * total_elems * bits_per_element / 8.0)
    if bits_per_element is None:
        return deg * _wire_leaf_bytes(tree, backend)
    return int(deg * total_elems * bits_per_element / 8.0)


def hier_bytes_per_round(tree, backend: CommBackend, r: int = 0) -> dict:
    """Per-worker bytes of hierarchical round ``r``, level by level, on the
    dense backend (only node leaders ship the slow wire):

    * ``"inter"``: slow-link bytes per worker, the inter degree × the leaf
      bytes at the wire dtype, over the node size m;
    * ``"inter_site"``: the same per shipping leader (no amortization);
    * ``"intra_wire"``: fast-link bytes per worker, a ring all-reduce's
      ``2(m−1)/m`` × the f32 bytes, for the average and the rebroadcast;
    * ``"intra_result"``: the two all-reduces' result bytes.

    The sharded two-axis layout (no rebroadcast, no leader amortization)
    and a codec on the inter wire are ROADMAP queue A item 12."""
    top = backend.topology_at(r)
    if top.name != "hierarchical":
        raise ValueError(f"not a hierarchical topology: {top.name!r}")
    m = int(top.axis_sizes[1])
    elems = sum(int(np.prod(tuple(l.shape))) for l in tree_leaves(tree))
    site = len(hierarchical_inter_shifts(top)) * _wire_leaf_bytes(tree,
                                                                   backend)
    n_intra = 0 if m == 1 else 2
    return {
        "inter": site / m,
        "inter_site": site,
        "intra_wire": n_intra * (2.0 * (m - 1) / m) * 4 * elems,
        "intra_result": n_intra * 4 * elems,
    }
