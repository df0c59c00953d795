"""Gossip communication: the dense K-worker simulation backend and the
sharded backends over ``torch.distributed``.

Port of ``src/repro/core/gossip.py``.
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

* **The sharded backends** (:class:`ShardedComm`,
  :class:`HierarchicalComm`): one worker per rank, its leaves with a
  leading worker dim of 1.  The reference's ``ppermute`` becomes P2P
  (``dist.batch_isend_irecv``: each rank posts its sends and receives of
  one exchange at once, each exchange of a call under its own tag, so two
  exchanges with one peer, as on a ring of 2 or at the ±K/2 shifts of
  ``exponential``, never pair up wrongly); ``pmean`` becomes an
  ``all_reduce``.  Round ``r``'s P2P pairs depend on ``r``, so the
  sharded ``mix`` takes ``r`` as a host int (the trainer's ``t // p``); a
  static graph needs none.  On a card with the gloo backend each payload
  is staged through the mesh's pinned host buffers; with NCCL the card's
  tensors go to the library as they are.  ``sent_bytes`` and
  ``reduced_bytes`` count what this rank handed to ``isend`` and to
  ``all_reduce``.  Where a worker spans several ranks (the mesh axes off
  the topology: TP, FSDP or the inner data-parallel axis) each rank
  exchanges its own shards with the ranks at its inner place in the
  neighbour workers, and the collectives over workers run in the group
  of that place.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, Optional, Tuple

import numpy as np
import torch
import torch.distributed as dist

from repro_torch import resolve_device
from repro_torch.core.topology import (MembershipSchedule, Topology,
                                       TopologySchedule, active_edge_count,
                                       hierarchical_inter_shifts,
                                       hierarchical_self_weight,
                                       masked_matrix)
from repro_torch.tree import tree_leaves, tree_map

__all__ = ["CommBackend", "DenseComm", "HierarchicalComm", "ShardedComm",
           "gossip_bytes_per_round", "hier_bytes_per_round",
           "refuse_multi_axis", "select_round", "worker_mask_like"]

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
            return top.W
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
            return top.W
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


def _as_dict(tree):
    """A flat dict of tensors, and how to give a result back its form (a
    bare tensor travels as the one leaf ``""``)."""
    if isinstance(tree, dict):
        return tree, lambda d: d
    return {"": tree}, lambda d: d[""]


def refuse_multi_axis(what: str, comm) -> None:
    """Refuse a mix over per-shift neighbour copies or payloads (CPD-SGDM's
    ``xhat_nbrs``, MT's compressed correction) on a sharded graph of more
    than one axis: there ``w₀·v + Σ w·v_shift`` over the per-axis shifts
    is not a row of W (ROADMAP C.9)."""
    top = comm.topology
    sizes = tuple(int(n) for n in top.axis_sizes)
    if len(sizes) > 1:
        raise ValueError(
            f"{what} on the sharded backend needs a one-axis shift graph "
            f"(ring, exponential): on the {top.name!r} graph of axes "
            f"{sizes} its mix over the per-shift neighbours, "
            "w₀·v + Σ w·v_shift, is not a row of W — the weights sum to the "
            "number of axes and W's diagonal neighbours are never received "
            "(ROADMAP C.9).  Run it on a one-axis graph, or on the dense "
            "backend.")


@dataclasses.dataclass
class ShardedComm(CommBackend):
    """One worker per rank of a process group, P2P between neighbours.

    ``axis_names[i]`` is the axis of the worker ``mesh``
    (:class:`repro_torch.launch.mesh.WorkerMesh`) that carries topology
    axis ``i``.  Each leaf keeps a leading worker dim of 1; the rank's
    neighbour along axis ``i`` at shift ``s`` is the rank ``s`` further
    along that axis.  Takes a ``Topology`` or a ``TopologySchedule``, and a
    ``MembershipSchedule`` on a single worker axis (the reference's
    ``gossip.py:411-418``: per-worker edge pruning of a multi-axis
    exchange is not expressible there)."""

    topology: Topology  # or a TopologySchedule at construction
    axis_names: Tuple[str, ...] = ()
    mesh: object = None
    membership: Optional[MembershipSchedule] = None
    wire_dtype: str = "float32"

    def __post_init__(self):
        self._check_common()
        tops = (self.schedule.topologies if self.schedule is not None
                else (self.topology,))
        for top in tops:
            # 'complete' is the mean over every worker: no grid
            if top.name != "complete" and (
                    len(self.axis_names) != len(top.axis_sizes)):
                raise ValueError(
                    f"axis_names {self.axis_names} vs grid {top.axis_sizes}")
        if self.membership is not None:
            self.membership.validate()
            if self.membership.n_workers != self.topology.n_workers:
                raise ValueError(
                    f"membership K={self.membership.n_workers} != topology "
                    f"K={self.topology.n_workers}")
            if len(self.axis_names) != 1:
                raise ValueError(
                    "elastic membership on ShardedComm needs a single "
                    f"worker axis; got axis_names {self.axis_names}")
        self._bind_mesh()

    def _check_common(self):
        if self.wire_dtype not in _WIRE_DTYPES:
            raise ValueError(
                f"wire_dtype {self.wire_dtype!r} not in {_WIRE_DTYPES}")
        self._resolve(self.topology)
        self.axis_names = tuple(self.axis_names)

    def _bind_mesh(self):
        if self.mesh is None:
            raise ValueError("ShardedComm needs the worker mesh of its "
                             "process group (repro_torch.launch.mesh."
                             "make_mesh)")
        m = self.mesh
        # the mesh axes off the topology's split each worker (its TP, FSDP
        # or inner data-parallel ranks): a worker is a line over them
        self._inner = tuple(a for a in m.axis_names
                            if a not in self.axis_names)
        n_workers = int(math.prod(m.axis_sizes[m.axis_index(a)]
                                  for a in self.axis_names
                                  if a in m.axis_names))
        if n_workers != self.topology.n_workers:
            raise ValueError(f"{n_workers} workers on the mesh for "
                             f"{self.topology.n_workers} workers")
        # the ranks of every worker that share this one's inner coordinates
        self._workers = m.group(self.axis_names)
        for i, name in enumerate(self.axis_names):
            if name not in m.axis_names:
                raise ValueError(f"axis {name!r} not in the mesh's "
                                 f"{m.axis_names}")
            if (self.topology.name != "complete" and len(self.axis_names)
                    == len(self.topology.axis_sizes)
                    and m.axis_sizes[m.axis_index(name)]
                    != self.topology.axis_sizes[i]):
                raise ValueError(
                    f"mesh axis {name!r} has {m.axis_sizes[m.axis_index(name)]}"
                    f" ranks; topology axis {i} has "
                    f"{self.topology.axis_sizes[i]} workers")
        self.device = m.device
        self.sent_bytes = 0        # bytes handed to isend by this rank
        self.reduced_bytes = 0     # bytes handed to all_reduce
        self._full_counts: dict = {}

    # -- the wire ------------------------------------------------------------
    def _p2p(self, sends, recvs):
        """One exchange through the mesh (:meth:`WorkerMesh.p2p`: one
        batch, staged on a card under gloo): ``sends`` ``[(tensor, dst,
        tag)]`` and ``recvs`` ``[(out, src, tag)]``; the bytes handed to
        ``isend`` count in ``sent_bytes``."""
        self.sent_bytes += self.mesh.p2p(sends, recvs)

    def _all_reduce(self, t, group):
        """In-place ``all_reduce`` (sum) of ``t`` over ``group`` (the
        mesh's, staged as :meth:`_p2p` stages its payloads)."""
        self.reduced_bytes += t.numel() * t.element_size()
        return self.mesh.all_reduce(t, group)

    def _peer(self, axis: int, shift: int) -> int:
        return self.mesh.peer(self.axis_names[axis], shift)

    def _coord(self, axis: int) -> int:
        return self.mesh.coords[self.mesh.axis_index(self.axis_names[axis])]

    def _rank_on(self, axis: int, c: int) -> int:
        co = list(self.mesh.coords)
        co[self.mesh.axis_index(self.axis_names[axis])] = int(c)
        return self.mesh.rank_at(co)

    def _ends(self, axis: int, kind: str, arg):
        """``(dst, src)`` of one exchange: the rank this one sends to and
        the rank it receives from; ``kind`` "shift" (``arg`` the shift) or
        "perm" (``arg[j]``: the coordinate that coordinate j receives
        from)."""
        if kind == "shift":
            return self._peer(axis, -arg), self._peer(axis, arg)
        c = self._coord(axis)
        dst = [j for j, s in enumerate(arg) if int(s) == c]
        return self._rank_on(axis, dst[0]), self._rank_on(axis, arg[c])

    @property
    def _worker(self) -> int:
        """This rank's worker: row-major over the topology's axes."""
        return self.mesh.index(self.axis_names)

    def _worker_rank(self, worker: int, inner: Optional[int] = None) -> int:
        """The rank of ``worker`` at inner place ``inner`` (row-major over
        the mesh axes off the topology; this rank's by default)."""
        m = self.mesh
        base = m.rank if inner is None else m.rank_with(self._inner, inner)
        return m.rank_with(self.axis_names, worker, base)

    def _axis_size(self, axis: int) -> int:
        return int(self.mesh.axis_sizes[self.mesh.axis_index(
            self.axis_names[axis])])

    def exchange_ops(self, payload: dict, entries, out=None,
                     source_ok=None, tag0: int = 0):
        """The sends and receives of one exchange of every array of
        ``payload`` (each in its own dtype) through each ``(axis, kind,
        arg)`` entry of ``entries`` (:meth:`_ends`), entry j's array i
        under tag ``tag0 + j·n + i``, for a caller that posts them in a
        batch of its own; the receive buffers, one dict per entry, are the
        second item.  ``out``: those buffers, held by the caller (fresh
        ones otherwise).  ``source_ok``: per entry None or an (n,) bool
        mask over the entry's axis, True where the edge out of that source
        ships; a pruned edge's source sends nothing and its receiver gets
        zeros (which every codec decodes to 0)."""
        names = list(payload)
        sends, recvs, got = [], [], []
        for j, (ax, kind, arg) in enumerate(entries):
            dst, src = self._ends(ax, kind, arg)
            ship = take = True
            if source_ok is not None and source_ok[j] is not None:
                ok = np.asarray(source_ok[j], dtype=bool)  # lint: allow
                c = self._coord(ax)
                s = ((c + arg) % self._axis_size(ax) if kind == "shift"
                     else int(arg[c]))
                ship, take = bool(ok[c]), bool(ok[s])
            bufs = (out[j] if out is not None else
                    {k: torch.empty(payload[k].shape,
                                    dtype=payload[k].dtype,
                                    device=payload[k].device)
                     for k in names})
            for i, k in enumerate(names):
                tag = tag0 + j * len(names) + i
                if ship:
                    sends.append((payload[k].contiguous(), dst, tag))
                if take:
                    recvs.append((bufs[k], src, tag))
                else:
                    bufs[k].zero_()
            got.append(bufs)
        return (sends, recvs), got

    def exchange(self, payload: dict, entries, out=None,
                 source_ok=None) -> list:
        """:meth:`exchange_ops` posted as one P2P batch: what each entry's
        source sent, one dict per entry, in their order."""
        ops, got = self.exchange_ops(payload, entries, out, source_ok)
        self._p2p(*ops)
        return got

    def _wire_cast(self, x):
        """What ships: the neighbour payload in the wire dtype; the bf16
        payload as its i16 bits (the self term never ships)."""
        if self.wire_dtype == "bfloat16":
            return x.to(torch.bfloat16).view(torch.int16)
        return x

    def _unwire_cast(self, v):
        """A received payload back to f32 for the accumulation."""
        if self.wire_dtype == "bfloat16":
            return v.view(torch.bfloat16).to(torch.float32)
        return v.to(torch.float32)

    # -- raw neighbour exchanges -----------------------------------------------
    def receive_tree(self, tree, axis: int, shift: int):
        """Each leaf of worker (k+shift) on ``axis``, dtypes kept."""
        d, back = _as_dict(tree)
        return back(self.exchange(d, [(axis, "shift", shift)])[0])

    def receive_payload(self, payload: Dict[str, object], axis: int,
                        shift: int) -> Dict[str, object]:
        """One wire-codec payload from the (axis, shift) neighbour, each
        array in its own dtype (u8 bits, i32 indices, f32 scales)."""
        return self.receive_tree(dict(payload), axis, shift)

    def receive_payload_committed(self, payload: Dict[str, object],
                                  axis: int, shift: int,
                                  source_ok) -> Dict[str, object]:
        """:meth:`receive_payload` with the edges from sources whose
        ``source_ok`` is False pruned: such a source ships nothing, and
        its receiver gets zeros (which every codec decodes to 0)."""
        return self.exchange(dict(payload), [(axis, "shift", shift)],
                             source_ok=[source_ok])[0]

    def receive_payloads(self, payloads: dict, entries,
                         source_ok=None) -> list:
        """Per-leaf codec payloads, ``{leaf: {array: tensor}}``, through
        each ``(axis, kind, arg)`` entry, every array of every leaf in one
        batch (:meth:`exchange`): one such dict per entry."""
        flat = {(n, a): t for n, p in payloads.items() for a, t in p.items()}
        out = []
        for got in self.exchange(flat, entries, source_ok=source_ok):
            per = {n: {} for n in payloads}
            for (n, a), t in got.items():
                per[n][a] = t
            out.append(per)
        return out

    def stored_weights(self, r):
        """Round ``r``'s weights of a consensus over per-shift copies under
        its liveness, for this rank (``r`` a host int): None without a
        membership schedule or where every worker of the round is active,
        else ``(diag, edges, active)``.  ``edges`` holds one ``(axis,
        shift, coeff, source_ok)`` per non-self shift that is not a
        multiple of K (such a copy is the own value: its weight joins the
        diagonal).  ``coeff`` is the shift's weight where this rank and
        the shift's source are both active, else 0; ``source_ok`` the (K,)
        sources whose edge along the shift has both ends active; ``diag``
        is 1 minus the coefficients, all f32 as the reference rounds them
        (``cpdsgdm.py:371-381``, ``tracking.py:301-315``); ``active``
        whether this rank is."""
        if self.membership is None:
            return None
        l = self.live_round(r, "stored_weights(r)")
        act = np.asarray(self.active_at(l), dtype=bool)  # lint: allow
        if act.all():
            return None
        n = self.topology_at(l).n_workers
        k = self._coord(0)
        ks = np.arange(n)
        off, edges = 0.0, []
        for (ax, sh, w) in self.nonself_shifts():
            if sh % n == 0:
                continue
            coeff = w if act[k] and act[(k + sh) % n] else 0.0
            off += coeff
            edges.append((ax, sh, float(np.float32(coeff)),
                          act & act[(ks - sh) % n]))
        return float(np.float32(1.0 - off)), edges, bool(act[k])

    def shift_views(self, tree) -> Dict[ShiftKey, object]:
        return {(ax, sh): self.receive_tree(tree, ax, sh)
                for (ax, sh, _w) in self.nonself_shifts()}

    # -- mixing --------------------------------------------------------------
    def _mean_all(self, tree):
        """The exact mean over every worker (``complete``): an
        ``all_reduce`` sum over the workers' ranks at this rank's inner
        place (the whole process group where a worker is one rank), over
        K."""
        K = self.topology.n_workers

        def f(x):
            t = self._all_reduce(x.to(torch.float32).clone(), self._workers)
            return (t / K).to(x.dtype)
        return tree_map(f, tree)

    def _mix_with(self, top: Topology, tree):
        """One round under ``top``: per topology axis, in order, every
        exchange of the axis in one batch and ``Σ w·view`` accumulated in
        f32 in the topology's order (the self term unshipped)."""
        if top.name == "complete":
            return self._mean_all(tree)
        if top.name == "disconnected":
            return tree
        per_axis: Dict[int, list] = {}
        for (ax, sh, w) in top.shifts:
            per_axis.setdefault(ax, []).append(("shift", sh, w))
        for (ax, recv, w) in top.perms:
            per_axis.setdefault(ax, []).append(("perm", recv, w))
        y, back = _as_dict(tree)
        for ax in sorted(per_axis):
            entries = per_axis[ax]
            remote = [(ax, kind, arg) for (kind, arg, _w) in entries
                      if not (kind == "shift" and arg == 0)]
            payload = {k: self._wire_cast(v) for k, v in y.items()}
            got = iter(self.exchange(payload, remote))
            views = [None if (kind == "shift" and arg == 0) else next(got)
                     for (kind, arg, _w) in entries]
            new = {}
            for k, x in y.items():
                acc = None
                for (kind, arg, w), v in zip(entries, views):
                    v = (x.to(torch.float32) if v is None
                         else self._unwire_cast(v[k]))
                    term = v * float(np.float32(w))
                    acc = term if acc is None else acc + term
                new[k] = acc.to(x.dtype)
            y = new
        return back(y)

    def _mix_with_masked(self, top: Topology, act, tree):
        """One round under ``top`` with only ``act`` workers exchanging:
        each exchange pruned to edges whose two ends are active, this
        worker's coefficient of each taken from the exchange's own
        ``(shift, w)`` entry (never read back from the masked matrix, where
        the aliased ±K/2 shifts of ``exponential`` share a cell) and the
        lost mass moved to its self weight."""
        act = np.asarray(act, dtype=bool)  # lint: allow
        if act.all():
            return self._mix_with(top, tree)
        if top.name == "disconnected":
            return tree
        n = int(top.axis_sizes[0])
        k = self._coord(0)
        ks = np.arange(n)
        # per exchange: (coeff, any pair active, entry, the sources whose
        # edge ships: both ends active)
        entries, off_diag = [], 0.0
        for (_ax, sh, w) in top.shifts:
            if sh % n == 0:
                continue
            coeff = w if act[k] and act[(k + sh) % n] else 0.0
            ok = act & act[(ks - sh) % n]
            entries.append((coeff, bool(ok.any()), (0, "shift", sh), ok))
            off_diag += coeff
        for (_ax, recv, w) in top.perms:
            src = np.asarray(recv, dtype=np.int64)  # lint: allow
            dst = np.empty(n, dtype=np.int64)
            dst[src] = ks
            coeff = w if src[k] != k and act[k] and act[src[k]] else 0.0
            ok = (dst != ks) & act & act[dst]
            entries.append((coeff, bool(ok.any()), (0, "perm", recv), ok))
            off_diag += coeff
        diag = float(np.float32(1.0 - off_diag))
        x_d, back = _as_dict(tree)
        views = self.exchange(
            {kk: self._wire_cast(v) for kk, v in x_d.items()},
            [e for (_c, _a, e, _ok) in entries],
            source_ok=[ok for (_c, _a, _e, ok) in entries])
        out = {}
        for kk, x in x_d.items():
            acc = x.to(torch.float32) * diag
            for (coeff, anyp, _e, _ok), got in zip(entries, views):
                if anyp:
                    acc = acc + self._unwire_cast(got[kk]) * float(
                        np.float32(coeff))
            out[kk] = acc.to(x.dtype)
        return back(out)

    def _host_round(self, r, what: str, call: str) -> int:
        """Round ``r`` as a host int: its P2P pairs are built on the host."""
        if r is None:
            raise ValueError(f"ShardedComm with {what} needs the round "
                             f"index: {call}")
        if isinstance(r, torch.Tensor):
            raise TypeError(
                f"ShardedComm with {what} selects round r's exchanges on the "
                f"host: pass r as an int (the trainer's t // p), not a "
                f"device tensor: {call}")
        return int(r)

    def live_round(self, r, call: str) -> int:
        """Round ``r``'s place in the membership cycle, on the host."""
        cyc = self.round_cycle
        return 0 if cyc == 1 else self._host_round(
            r, "a MembershipSchedule", call) % cyc

    def mix(self, tree, r=None):
        """Σⱼ w_kj x⁽ʲ⁾ for this rank's worker with round ``r``'s graph and
        liveness (``r`` a host int; a static graph ignores it)."""
        if self.membership is not None:
            l = self.live_round(r, "mix(tree, r=...)")
            return self._mix_with_masked(self.topology_at(l),
                                         self.active_at(l), tree)
        if self.period == 1:
            return self._mix_with(self.topology, tree)
        l = self._host_round(r, "a TopologySchedule", "mix(tree, r=...)")
        return self._mix_with(self.topology_at(l), tree)

    def stale_mix(self, tree, r=None):
        if self.membership is None:
            return self.mix(tree, r=r)
        l = self.live_round(r, "stale_mix(tree, r=...)")
        return self._mix_with_masked(self.topology_at(l),
                                     self.active_at(l + 1), tree)


@dataclasses.dataclass
class HierarchicalComm(ShardedComm):
    """Two-level sharded backend on the ``(n_nodes, node_size)`` grid of a
    ``"hierarchical"`` topology (or a schedule of them): the exact in-node
    mean, the inter-node exchange between node leaders, the result back
    to every worker of the node.

    * ``axis_names = (name,)``: one flat axis of ``n_nodes·node_size``
      ranks; rank ``i·m + j`` is member j of node i, member 0 its leader.
      The in-node mean is an ``all_reduce`` over the node's subgroup, the
      inter exchange runs between leaders only (the other members receive
      zeros), and the rebroadcast is an ``all_reduce`` sum of the leader's
      value over the node.
    * ``axis_names = (inter, intra)``: the node is the ``intra`` mesh axis.
      The mean runs over that axis's subgroup, every rank exchanges along
      ``inter`` (no leader amortization) and no rebroadcast is needed.

    ``inter_codec`` compresses the inter wire with a keyless codec
    (identity, sign, QSGD, top-k); on the kernel layout a codec with a
    rows format at the lane block packs and decodes through its kernels,
    on every rank, as the reference packs and decodes on every device.
    Every subgroup is created when the comm is built, on every rank in the
    same order."""

    inter_codec: Optional[object] = None

    def __post_init__(self):
        self._check_common()
        tops = (self.schedule.topologies if self.schedule is not None
                else (self.topology,))
        for top in tops:
            if top.name != "hierarchical" or len(top.axis_sizes) != 2:
                raise ValueError(
                    "HierarchicalComm needs hierarchical (n_nodes, "
                    f"node_size) topologies; got {top.name!r} with grid "
                    f"{top.axis_sizes}")
        if len(self.axis_names) not in (1, 2):
            raise ValueError(
                "HierarchicalComm maps onto one flat worker axis or an "
                f"(inter, intra) axis pair; got {self.axis_names}")
        if self.membership is not None:
            raise ValueError(
                "elastic membership on HierarchicalComm is not supported: "
                "masked two-level rounds are not expressible as pruned "
                "grouped collectives; run hierarchical churn on DenseComm")
        if self.inter_codec is not None:
            if getattr(self.inter_codec, "name", "") == "randk":
                raise ValueError(
                    "randk inter_codec needs a shared per-round key; use "
                    "identity/sign/qsgd/topk on the inter wire")
            if self.wire_dtype != "float32":
                raise ValueError(
                    "inter_codec already defines the wire encoding; "
                    "combine it with wire_dtype='float32'")
        self._bind_mesh()
        n, m = self.n_nodes, self.node_size
        if len(self.axis_names) == 1:
            mesh = self.mesh
            self._node_group = None
            if m > 1:
                # collective: every rank builds every node's group of every
                # inner place of a worker, in order
                mine = mesh.index(self._inner)
                for c in range(mesh.size(self._inner)):
                    for i in range(n):
                        g = dist.new_group([self._worker_rank(i * m + j, c)
                                            for j in range(m)])
                        if self._worker // m == i and mine == c:
                            self._node_group = g
        else:
            intra = self.axis_names[1]
            self._node_group = self.mesh.groups.get(intra)

    @property
    def n_nodes(self) -> int:
        return int(self.topology.axis_sizes[0])

    @property
    def node_size(self) -> int:
        return int(self.topology.axis_sizes[1])

    @property
    def hier_leader_pruned(self) -> bool:
        """True when only node leaders ship the inter wire (flat layout)."""
        return len(self.axis_names) == 1

    def _level_ops(self, top: Topology):
        """``node_avg(x)`` (the exact in-node mean, f32),
        ``recv(payload, shift, j)`` (the inter exchange of a dict of
        arrays, exchange j's tags) and ``rebroadcast(acc)``."""
        n, m = int(top.axis_sizes[0]), int(top.axis_sizes[1])
        group = self._node_group

        def node_avg(x):
            x32 = x.to(torch.float32)
            if m == 1:
                return x32
            return self._all_reduce(x32.clone(), group) / m

        def exchange(payload, dst, src, j, active=True):
            got = {k: torch.zeros_like(v) for k, v in payload.items()}
            if active:
                names = list(payload)
                self._p2p(
                    [(payload[k].contiguous(), dst, j * len(names) + i)
                     for i, k in enumerate(names)],
                    [(got[k], src, j * len(names) + i)
                     for i, k in enumerate(names)])
            return got

        if len(self.axis_names) == 2:
            inter = self.axis_names[0]

            def recv(payload, sh, j):
                return exchange(payload, self.mesh.peer(inter, -sh),
                                self.mesh.peer(inter, sh), j)

            return node_avg, recv, (lambda acc: acc)

        me = self._worker
        leader = me % m == 0
        i = me // m
        at = self._worker_rank

        def recv(payload, sh, j):
            # leaders only: the other members receive zeros, which the
            # rebroadcast overwrites
            return exchange(payload, at(((i - sh) % n) * m),
                            at(((i + sh) % n) * m), j, active=leader)

        def rebroadcast(acc):
            if m == 1:
                return acc
            only = acc if leader else torch.zeros_like(acc)
            return self._all_reduce(only.contiguous(), group)

        return node_avg, recv, rebroadcast

    def _codec_rows(self, src) -> bool:
        c = self.inter_codec
        return (c is not None and c.rows_supported
                and c.block == src.shape[-1])

    def _pack(self, src, rows: bool):
        """The codec payload of ``src``: through its kernels on the kernel
        layout (every row a full block, as the reference's per-leaf pack
        of the matrix sees it), else the per-leaf pack."""
        c = self.inter_codec
        if not rows:
            return c.pack(src)
        u = src.shape[-2]
        mat = src.reshape(-1, u, src.shape[-1])[0]
        key = (u, src.device)
        counts = self._full_counts.get(key)
        if counts is None:
            counts = torch.full((u, 1), float(src.shape[-1]),
                                device=src.device)
            self._full_counts[key] = counts
        return c.rows_pack(mat, counts=counts)

    def _unpack(self, got, src, rows: bool):
        c = self.inter_codec
        if not rows:
            return c.unpack(got, src.numel(), src.shape, torch.float32)
        return c.rows_unpack(got).reshape(src.shape)

    def _inter_mix(self, xa, top, recv, *, wire=None, unwire=None):
        """The weighted inter-node sum on a node mean ``xa`` (f32);
        ``wire``/``unwire`` cut what ships to the plan's used rows and pad
        it back after the decode."""
        inter = hierarchical_inter_shifts(top)
        ws = hierarchical_self_weight(top)
        if not inter:
            return xa
        if wire is None:
            wire = unwire = (lambda v: v)
        acc = xa * float(np.float32(ws))
        src = wire(xa).contiguous()
        if self.inter_codec is not None:
            rows = self._codec_rows(src)
            pay = self._pack(src, rows)
            for j, (sh, w) in enumerate(inter):
                dec = self._unpack(recv(pay, sh, j), src, rows)
                acc = acc + unwire(dec) * float(np.float32(w))
        else:
            payload = {"x": self._wire_cast(src)}
            for j, (sh, w) in enumerate(inter):
                v = self._unwire_cast(recv(payload, sh, j)["x"])
                acc = acc + unwire(v) * float(np.float32(w))
        return acc

    def _mix_with(self, top: Topology, tree):
        node_avg, recv, rebroadcast = self._level_ops(top)

        def mix_leaf(x):
            acc = self._inter_mix(node_avg(x), top, recv)
            return rebroadcast(acc).to(x.dtype)

        return tree_map(mix_leaf, tree)

    def mix_mat(self, x_mat, *, plan=None, r: int = 0):
        """The two-level round on the kernel matrix, cut to
        ``plan.used_rows`` at every level: the alignment tail is zero on
        every worker and stays zero through the mean and the inter mix, so
        the in-node all-reduces and the inter wire move the accounted
        bytes (``hier_bytes_per_round`` of the used rows) and the tail is
        padded back at the end.  Static graphs (a schedule goes through
        :meth:`mix`)."""
        top = self.topology_at(r)
        node_avg, recv, rebroadcast = self._level_ops(top)
        u = None if plan is None else int(plan.used_rows)
        cut = u is not None and u < x_mat.shape[-2]
        x = x_mat[..., :u, :] if cut else x_mat
        acc = rebroadcast(self._inter_mix(node_avg(x), top, recv))
        if cut:
            acc = plan.pad_wire(acc)
        return acc.to(x_mat.dtype)

    def shift_views(self, tree):
        raise NotImplementedError(
            "HierarchicalComm has no flat per-shift views: the inter wire "
            "moves node means between leaders, not raw worker tensors")


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
    """Per-worker bytes of hierarchical round ``r``, level by level:

    * ``"inter"``: slow-link bytes per worker, the inter degree × the
      payload (the codec's wire bytes with an ``inter_codec``, else the
      leaf bytes at the wire dtype), over the node size m where only the
      leaders ship (the flat layout and the dense backend);
    * ``"inter_site"``: the same per shipping rank (no amortization);
    * ``"intra_wire"``: fast-link bytes per worker, a ring all-reduce's
      ``2(m−1)/m`` × the f32 bytes per in-node collective (the mean and
      the rebroadcast on the flat layout, the mean alone on the two-axis
      layout);
    * ``"intra_result"``: those all-reduces' result bytes."""
    top = backend.topology_at(r)
    if top.name != "hierarchical":
        raise ValueError(f"not a hierarchical topology: {top.name!r}")
    m = int(top.axis_sizes[1])
    leaves = tree_leaves(tree)
    elems = sum(int(np.prod(tuple(l.shape))) for l in leaves)
    codec = getattr(backend, "inter_codec", None)
    if codec is not None:
        payload = sum(codec.wire_bytes(int(np.prod(tuple(l.shape))))
                      for l in leaves)
    else:
        payload = _wire_leaf_bytes(tree, backend)
    pruned = bool(getattr(backend, "hier_leader_pruned", True))
    site = len(hierarchical_inter_shifts(top)) * payload
    n_intra = 0 if m == 1 else (2 if pruned else 1)
    return {
        "inter": site / m if pruned else float(site),
        "inter_site": site,
        "intra_wire": n_intra * (2.0 * (m - 1) / m) * 4 * elems,
        "intra_result": n_intra * 4 * elems,
    }
