"""Gossip topologies, mixing matrices and time-varying schedules (numpy
only).

Port of ``src/repro/core/topology.py:61-780``.  A topology holds a
doubly-stochastic mixing matrix ``W`` over K workers (paper §3.2,
Assumption 1) and its neighbour structure: weighted circulant shifts per
worker-grid axis, which the kernel path turns into shifted views mixed by
the fused AXPY, and, for non-circulant graphs such as random matchings,
explicit per-axis permutations (``perms``).  A :class:`TopologySchedule` is
a periodic sequence ``W_1, …, W_T``: round ``r`` gossips with
``W_{(r mod T)+1}``; what governs convergence is the mixing of the cycle
product ``W_T ⋯ W_1`` (:attr:`TopologySchedule.cycle_rho`).  A
:class:`MembershipSchedule` is elastic membership: per round, which workers
hold state (``live``) and which exchange (``active``); :func:`masked_matrix`
is a round's mixing matrix with only the active workers exchanging.
:func:`hierarchical` lifts an inter-node graph over a two-level worker
grid ``(n_nodes, node_size)`` as ``W_inter ⊗ (1/m)11ᵀ`` (exact in-node
average), and :func:`hierarchical_schedule` lifts the one-peer exponential
schedule the same way.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Optional, Sequence

import numpy as np

__all__ = [
    "Topology", "TopologySchedule",
    "ring", "torus", "complete", "exponential", "disconnected",
    "spectral_gap", "mixing_gap", "cycle_spectral_gap",
    "is_doubly_stochastic", "make_topology", "make_schedule",
    "static_schedule", "one_peer_exponential_schedule",
    "alternating_axes_schedule", "random_matching_schedule",
    "hierarchical", "hierarchical_schedule", "hierarchical_inter_shifts",
    "hierarchical_self_weight",
    "MembershipSchedule", "full_membership", "membership_from_events",
    "masked_matrix", "active_edge_count", "exchanges",
]

def is_doubly_stochastic(W: np.ndarray, atol: float = 1e-8,
                         require_symmetric: bool = True) -> bool:
    """Assumption 1: rows and columns sum to one, entries in [0, 1];
    symmetry is waived for the per-round matrices of time-varying
    schedules (one-peer exponential rounds are directed)."""
    W = np.asarray(W, dtype=np.float64)
    if W.ndim != 2 or W.shape[0] != W.shape[1]:
        return False
    ones = np.ones(W.shape[0])
    return (
        (not require_symmetric or np.allclose(W, W.T, atol=atol))
        and np.allclose(W @ ones, ones, atol=atol)
        and np.allclose(ones @ W, ones, atol=atol)
        and bool(np.all(W >= -atol))
        and bool(np.all(W <= 1 + atol))
    )


def spectral_gap(W: np.ndarray) -> float:
    """ρ = 1 − |λ₂| (Lemma 1); ρ ∈ (0, 1] for connected non-bipartite W."""
    W = np.asarray(W, dtype=np.float64)
    eig = np.sort(np.abs(np.linalg.eigvalsh(W)))[::-1]
    if len(eig) == 1:
        return 1.0
    return float(1.0 - eig[1])


def mixing_gap(W: np.ndarray) -> float:
    """``1 − ‖W − (1/K)11ᵀ‖₂``: ``1 − |λ₂|`` for a symmetric W, and
    meaningful for asymmetric doubly-stochastic W and cycle products."""
    W = np.asarray(W, dtype=np.float64)
    K = W.shape[0]
    if K == 1:
        return 1.0
    J = np.ones((K, K)) / K
    return float(1.0 - np.linalg.norm(W - J, 2))


def cycle_spectral_gap(Ws: Sequence[np.ndarray]) -> float:
    """``1 − ‖W_T ⋯ W_1 − J‖₂``, round 1 applied first."""
    Ws = [np.asarray(W, dtype=np.float64) for W in Ws]
    P = np.eye(Ws[0].shape[0])
    for W in Ws:
        P = W @ P
    return mixing_gap(P)


@dataclasses.dataclass(frozen=True)
class Topology:
    """A gossip graph over ``n_workers`` with doubly-stochastic weights.

    Attributes:
      name: identifier ("ring", "torus", "complete", "exponential", ...).
      W: dense (K, K) mixing matrix, numpy float64.
      shifts: ((axis, shift, weight), ...) — the circulant exchanges;
        ``axis`` indexes ``axis_sizes`` and shift 0 is the self weight.
      axis_sizes: worker-grid shape whose product is K.
      perms: ((axis, recv_from, weight), ...) — non-circulant exchanges,
        where position i of the tuple ``recv_from`` receives the value held
        by ``recv_from[i]`` (random-matching rounds).
      symmetric: whether W is symmetric; per-round matrices of schedules
        may be asymmetric (one-peer exponential).
    """

    name: str
    W: np.ndarray
    shifts: tuple
    axis_sizes: tuple
    perms: tuple = ()
    symmetric: bool = True

    @property
    def n_workers(self) -> int:
        return int(self.W.shape[0])

    @property
    def rho(self) -> float:
        return spectral_gap(self.W) if self.symmetric else mixing_gap(self.W)

    @property
    def degree(self) -> int:
        """Non-self exchanges per worker per round: what the bytes on the
        wire scale with.  Each perm entry is one payload."""
        return (sum(1 for (_, s, _) in self.shifts if s != 0)
                + len(self.perms))

    def self_weight(self) -> float:
        return float(self.W[0, 0])

    def structure_matrix(self) -> np.ndarray:
        """Dense W rebuilt from the shift and perm structure, applied per
        axis in order — what the exchanges execute."""
        grid = self.axis_sizes
        K = self.n_workers
        axes = sorted({ax for (ax, _, _) in self.shifts}
                      | {ax for (ax, _, _) in self.perms})
        W = np.eye(K)
        for ax in axes:
            A = np.zeros((K, K))
            n = grid[ax]
            for (a, sh, w) in self.shifts:
                if a != ax:
                    continue
                for k in range(K):
                    idx = list(np.unravel_index(k, grid))
                    idx[ax] = (idx[ax] + sh) % n
                    A[k, np.ravel_multi_index(idx, grid)] += w
            for (a, recv, w) in self.perms:
                if a != ax:
                    continue
                for k in range(K):
                    idx = list(np.unravel_index(k, grid))
                    idx[ax] = recv[idx[ax]]
                    A[k, np.ravel_multi_index(idx, grid)] += w
            W = A @ W
        return W

    def validate(self) -> None:
        if not is_doubly_stochastic(self.W,
                                    require_symmetric=self.symmetric):
            raise ValueError(f"topology {self.name}: W is not doubly "
                             "stochastic")
        if int(np.prod(self.axis_sizes)) != self.n_workers:
            raise ValueError(f"topology {self.name}: axis_sizes "
                             f"{self.axis_sizes} != K")
        for (ax, recv, _w) in self.perms:
            n = self.axis_sizes[ax]
            if sorted(recv) != list(range(n)):
                raise ValueError(
                    f"topology {self.name}: perm {recv} on axis {ax} is not "
                    f"a permutation of range({n})")


def _circulant(K: int, offsets_weights: dict) -> np.ndarray:
    W = np.zeros((K, K), dtype=np.float64)
    for off, w in offsets_weights.items():
        for i in range(K):
            W[i, (i + off) % K] += w
    return W


def ring(K: int, self_weight: float | None = None) -> Topology:
    """Ring of K workers (the paper's experimental topology, K=8).

    Default weights: 1/3 self, 1/3 each neighbour; K=2 is a pair average
    and K=1 the identity.
    """
    if K == 1:
        return Topology("ring", np.ones((1, 1)), ((0, 0, 1.0),), (1,))
    if K == 2:
        W = np.array([[0.5, 0.5], [0.5, 0.5]])
        return Topology("ring", W, ((0, 0, 0.5), (0, 1, 0.5)), (2,))
    ws = 1.0 / 3.0 if self_weight is None else float(self_weight)
    wn = (1.0 - ws) / 2.0
    W = _circulant(K, {0: ws, 1: wn, -1: wn})
    shifts = ((0, 0, ws), (0, 1, wn), (0, -1, wn))
    return Topology("ring", W, shifts, (K,))


def torus(shape: Sequence[int], self_weight: float | None = None) -> Topology:
    """Kronecker torus W = W_ring(shape[0]) ⊗ …, mixed one axis at a time."""
    shape = tuple(int(s) for s in shape)
    mats = [ring(s, self_weight).W for s in shape]
    W = mats[0]
    for M in mats[1:]:
        W = np.kron(W, M)
    shifts = []
    for ax, s in enumerate(shape):
        sub = ring(s, self_weight)
        for (_, sh, w) in sub.shifts:
            shifts.append((ax, sh, w))
    return Topology("torus", W, tuple(shifts), shape)


def complete(K: int) -> Topology:
    """Fully connected: W = (1/K) 11ᵀ — gossip is the exact global mean."""
    W = np.full((K, K), 1.0 / K)
    shifts = tuple((0, s, 1.0 / K) for s in range(K))
    return Topology("complete", W, shifts, (K,))


def exponential(K: int) -> Topology:
    """One peer per power of two on each side (hypercube-like): a good ρ at
    degree 2·⌈log₂K⌉.  At K a power of two the shifts ±K/2 name one
    neighbour, which W counts twice (the symmetrised circulant) and the
    shift list carries as two exchanges."""
    offs = [0]
    s = 1
    while s < K:
        offs.append(s)
        offs.append(-s)
        s *= 2
    w = 1.0 / len(offs)
    W = _circulant(K, {o: w for o in offs})
    W = (W + W.T) / 2.0
    shifts = tuple((0, o, w) for o in offs)
    return Topology("exponential", W, shifts, (K,))


def disconnected(K: int) -> Topology:
    """W = I: no communication at all (lower bound / ablation)."""
    return Topology("disconnected", np.eye(K), ((0, 0, 1.0),), (K,))


def _hier_compose(sub: Topology, n_nodes: int, node_size: int) -> Topology:
    """Lift an inter-node graph ``sub`` over ``n_nodes`` to the two-level
    worker grid ``(n_nodes, node_size)``: W = W_inter ⊗ W_intra with
    W_intra = (1/m)11ᵀ (exact in-node average)."""
    m = int(node_size)
    C = np.full((m, m), 1.0 / m)
    W = np.kron(sub.W, C)
    shifts = (tuple((0, sh, w) for (_, sh, w) in sub.shifts)
              + tuple((1, s, 1.0 / m) for s in range(m)))
    return Topology("hierarchical", W, shifts, (int(n_nodes), m),
                    symmetric=bool(np.allclose(W, W.T)))


def hierarchical(n_nodes: int, node_size: int, *,
                 inter: str = "ring") -> Topology:
    """Two-level gossip graph: an exact average inside every node of
    ``node_size`` workers (the fast links), then ``inter`` ("ring",
    "exponential" or "complete") between the ``n_nodes`` nodes (the slow
    links).  ``W = W_inter ⊗ (1/m)11ᵀ``: axis 1 (in-node) applies after
    axis 0 in :meth:`Topology.structure_matrix`, as the sharded round
    averages in-node first and then gossips between node leaders."""
    n, m = int(n_nodes), int(node_size)
    if n < 1 or m < 1:
        raise ValueError(
            f"hierarchical: need n_nodes ≥ 1 and node_size ≥ 1, got "
            f"({n_nodes}, {node_size})")
    sub = make_topology(inter, (n,))
    if sub.perms:
        raise ValueError(
            f"hierarchical: inter graph {inter!r} must be shift-structured")
    return _hier_compose(sub, n, m)


def hierarchical_inter_shifts(top: Topology) -> tuple:
    """Non-self inter-node exchanges of a hierarchical topology, as
    ``(shift, weight)`` pairs on the node axis (axis 0)."""
    n = int(top.axis_sizes[0])
    return tuple((sh % n, w) for (ax, sh, w) in top.shifts
                 if ax == 0 and sh % n != 0)


def hierarchical_self_weight(top: Topology) -> float:
    """Inter-level self weight of a hierarchical topology: the mass each
    node keeps of its own post-average value."""
    n = int(top.axis_sizes[0])
    return float(sum(w for (ax, sh, w) in top.shifts
                     if ax == 0 and sh % n == 0))


def make_topology(name: str, worker_grid: Sequence[int]) -> Topology:
    """Build a topology by name for a worker grid (product = K)."""
    worker_grid = tuple(int(g) for g in worker_grid)
    K = int(np.prod(worker_grid)) if worker_grid else 1
    if name == "ring":
        return ring(K)
    if name == "torus":
        grid = worker_grid if len(worker_grid) > 1 else (K,)
        return torus(grid)
    if name == "complete":
        return complete(K)
    if name == "exponential":
        return exponential(K)
    if name == "disconnected":
        return disconnected(K)
    if name == "hierarchical":
        if len(worker_grid) != 2:
            raise ValueError(
                "hierarchical topology needs a (n_nodes, node_size) worker "
                f"grid; got {worker_grid}")
        return hierarchical(worker_grid[0], worker_grid[1])
    raise ValueError(f"unknown topology {name!r}")


# ------------------------------------------------------------------ schedules
@dataclasses.dataclass(frozen=True)
class TopologySchedule:
    """A periodic sequence of topologies: round ``r`` uses ``at(r)``.

    All rounds share ``n_workers`` and ``axis_sizes``; only the exchange
    pattern varies.  The round index is derived from the optimizer's step
    counter (``r = step // p − 1`` at gossip time).
    """

    name: str
    topologies: tuple  # (Topology, ...), length T ≥ 1

    def __post_init__(self):
        if not self.topologies:
            raise ValueError(f"schedule {self.name}: needs ≥ 1 topology")

    @property
    def period(self) -> int:
        return len(self.topologies)

    @property
    def n_workers(self) -> int:
        return self.topologies[0].n_workers

    @property
    def axis_sizes(self) -> tuple:
        return self.topologies[0].axis_sizes

    def at(self, r: int) -> Topology:
        """Topology of round ``r`` (0-based, wraps modulo the period)."""
        return self.topologies[int(r) % self.period]

    def stacked_W(self) -> np.ndarray:
        """(T, K, K) weights — what DenseComm indexes per round."""
        return np.stack([t.W for t in self.topologies])

    def cycle_product(self) -> np.ndarray:
        """``W_T ⋯ W_1`` (round 0 applied first, as in ``x ← W x``)."""
        P = np.eye(self.n_workers)
        for t in self.topologies:
            P = t.W @ P
        return P

    @property
    def cycle_rho(self) -> float:
        """Effective spectral gap of one full cycle, ``1 − ‖∏W − J‖₂``."""
        return mixing_gap(self.cycle_product())

    def degrees(self) -> tuple:
        """Non-self exchanges per round (the bytes vary by round)."""
        return tuple(t.degree for t in self.topologies)

    def validate(self) -> None:
        K, grid = self.n_workers, self.axis_sizes
        for t in self.topologies:
            t.validate()
            if t.n_workers != K or t.axis_sizes != grid:
                raise ValueError(
                    f"schedule {self.name}: round {t.name} grid "
                    f"{t.axis_sizes} != {grid}")


def static_schedule(top: Topology) -> TopologySchedule:
    """A single topology as a period-1 schedule."""
    return TopologySchedule(f"static_{top.name}", (top,))


def one_peer_exponential_schedule(K: int,
                                  self_weight: float = 0.5) -> TopologySchedule:
    """One-peer exponential: round ``j`` exchanges only with offset ``2^j``.

    Degree 1 a round, each round's W directed, yet the ⌈log₂K⌉-round cycle
    product is the exact global average when K is a power of two
    (``cycle_rho = 1``).
    """
    if K == 1:
        return static_schedule(disconnected(1))
    ws = float(self_weight)
    T = max(1, math.ceil(math.log2(K)))
    tops = []
    for j in range(T):
        off = 2 ** j
        W = np.zeros((K, K))
        for i in range(K):
            W[i, i] += ws
            W[i, (i + off) % K] += 1.0 - ws
        tops.append(Topology(
            f"one_peer_exp[{off}]", W,
            ((0, 0, ws), (0, off, 1.0 - ws)), (K,),
            symmetric=bool(np.allclose(W, W.T))))
    return TopologySchedule("one_peer_exp", tuple(tops))


def hierarchical_schedule(n_nodes: int, node_size: int,
                          self_weight: float = 0.5) -> TopologySchedule:
    """Two-level schedule: one-peer exponential between nodes, an exact
    average inside every node, every round.  Round ``j`` is the one-peer
    round ``R_j`` over nodes lifted to ``R_j ⊗ (1/m)11ᵀ``: one inter-node
    wire a node a round, and at a power-of-two ``n_nodes`` the cycle
    product is the exact global average."""
    n, m = int(n_nodes), int(node_size)
    if n == 1:
        return static_schedule(hierarchical(1, m))
    base = one_peer_exponential_schedule(n, self_weight)
    tops = tuple(_hier_compose(t, n, m) for t in base.topologies)
    return TopologySchedule("hier_one_peer", tops)


def alternating_axes_schedule(shape: Sequence[int],
                              self_weight: float | None = None
                              ) -> TopologySchedule:
    """Ring mixing along one torus axis per round: round ``ax`` applies
    ``I ⊗ … ⊗ W_ring(shape[ax]) ⊗ … ⊗ I``; the cycle product is the full
    Kronecker torus W."""
    shape = tuple(int(s) for s in shape)
    tops = []
    for ax in range(len(shape)):
        sub = ring(shape[ax], self_weight)
        mats = [sub.W if a == ax else np.eye(s)
                for a, s in enumerate(shape)]
        W = mats[0]
        for M in mats[1:]:
            W = np.kron(W, M)
        shifts = tuple((ax, sh, w) for (_, sh, w) in sub.shifts)
        tops.append(Topology(f"axis{ax}_ring", W, shifts, shape))
    return TopologySchedule("alt_axes", tuple(tops))


def random_matching_schedule(K: int, rounds: int, seed: int = 0,
                             self_weight: float = 0.5) -> TopologySchedule:
    """Seeded random perfect matchings: each round pairs workers at random
    and pair-averages (``W = ws·I + (1−ws)·M``); with odd K one worker
    idles a round.  The matchings come from ``np.random.default_rng(seed)``
    as the reference draws them, so both packages see the same rounds."""
    if rounds < 1:
        raise ValueError("random_matching_schedule: rounds must be ≥ 1")
    rng = np.random.default_rng(seed)
    ws = float(self_weight)
    tops = []
    for r in range(rounds):
        order = rng.permutation(K)
        recv = np.arange(K)
        for a, b in zip(order[0::2], order[1::2]):
            recv[a], recv[b] = b, a
        W = ws * np.eye(K)
        for i in range(K):
            W[i, recv[i]] += 1.0 - ws
        tops.append(Topology(
            f"matching[{r}]", W, ((0, 0, ws),), (K,),
            perms=((0, tuple(int(x) for x in recv), 1.0 - ws),)))
    return TopologySchedule("random_matching", tuple(tops))


def make_schedule(name: str, worker_grid: Sequence[int], *,
                  base_topology: str = "ring", rounds: int = 0,
                  seed: int = 0) -> TopologySchedule:
    """Build a topology schedule by name for a worker grid.

    ``"static"`` wraps ``base_topology``; ``rounds``/``seed`` set the
    random-matching schedule (``rounds=0`` derives ⌈log₂K⌉, at least 2).
    """
    grid = tuple(int(g) for g in worker_grid)
    K = int(np.prod(grid)) if grid else 1
    key = name.lower().replace("-", "_")
    if key == "static":
        return static_schedule(make_topology(base_topology, grid))
    if key in ("one_peer_exp", "one_peer_exponential"):
        if len(grid) > 1:
            raise ValueError(
                "one_peer_exp needs a single worker axis; got grid "
                f"{grid} (use alt_axes for multi-axis grids)")
        return one_peer_exponential_schedule(K)
    if key in ("alt_axes", "alternating_axes"):
        return alternating_axes_schedule(grid if len(grid) > 1 else (K,))
    if key in ("hier_one_peer", "hierarchical_one_peer"):
        if len(grid) != 2:
            raise ValueError(
                "hier_one_peer needs a (n_nodes, node_size) worker grid; "
                f"got {grid}")
        return hierarchical_schedule(grid[0], grid[1])
    if key in ("random_matching", "random_match"):
        if len(grid) > 1:
            raise ValueError(
                "random_matching needs a single worker axis; got grid "
                f"{grid}")
        T = rounds or max(2, math.ceil(math.log2(max(K, 2))))
        return random_matching_schedule(K, T, seed=seed)
    raise ValueError(f"unknown topology schedule {name!r}")


# --------------------------------------------------------- elastic membership
@dataclasses.dataclass(frozen=True)
class MembershipSchedule:
    """Per-round worker liveness for elastic membership, period ``M``.

    Two (M, K) bool masks, indexed ``[r % M, k]``:

    * ``live``: worker k still holds state in round r.  A dead worker has
      left the fleet: its row and column are masked out of the round's
      mixing matrix and none of its edges ship bytes.
    * ``active``: worker k takes part in round r's exchange.
      ``active ⊆ live``: a live worker that is not active is a
      **straggler**: it keeps training locally but skips the exchange
      (self-weight 1, its masked row is ``e_k``).

    The mixing matrix reads only ``active``; ``live`` drives the chaos
    harness's metrics (loss and consensus over live workers) and revival
    warm-starts.  The round index comes from the optimizer's step counter,
    as for a :class:`TopologySchedule`.
    """

    name: str
    live: np.ndarray      # (M, K) bool
    active: np.ndarray    # (M, K) bool, active ⊆ live

    @property
    def period(self) -> int:
        return int(self.live.shape[0])

    @property
    def n_workers(self) -> int:
        return int(self.live.shape[1])

    def live_at(self, r: int) -> np.ndarray:
        """(K,) bool: workers holding state in round ``r``."""
        return np.asarray(self.live[int(r) % self.period], dtype=bool)

    def active_at(self, r: int) -> np.ndarray:
        """(K,) bool: workers exchanging in round ``r``."""
        return np.asarray(self.active[int(r) % self.period], dtype=bool)

    def all_active(self) -> bool:
        return bool(np.all(self.active))

    def validate(self) -> None:
        live = np.asarray(self.live)
        active = np.asarray(self.active)
        if live.shape != active.shape or live.ndim != 2:
            raise ValueError(
                f"membership {self.name}: live {live.shape} and active "
                f"{active.shape} must both be (rounds, K)")
        if live.dtype != np.bool_ or active.dtype != np.bool_:
            raise ValueError(f"membership {self.name}: masks must be bool")
        if np.any(active & ~live):
            raise ValueError(
                f"membership {self.name}: active ⊄ live (a dead worker "
                "cannot exchange)")
        if not np.all(live.any(axis=1)):
            raise ValueError(
                f"membership {self.name}: some round has no live worker "
                "(nobody left to warm-start from)")


def full_membership(K: int, name: str = "full") -> MembershipSchedule:
    """Everyone live and active every round (period 1): every masked
    quantity equals its unmasked form."""
    ones = np.ones((1, K), dtype=bool)
    return MembershipSchedule(name, ones, ones.copy())


def membership_from_events(K: int, n_rounds: int,
                           events: Sequence) -> MembershipSchedule:
    """A period-``n_rounds`` membership from a fault script.

    ``events`` holds ``(round, kind, worker)`` triples, or objects with
    those attributes:

    * ``"kill"``: the worker leaves the fleet at that round (dead from
      then on, until revived);
    * ``"revive"``: the worker rejoins at that round (the chaos harness
      warm-starts its state from a live donor before the round runs);
    * ``"straggle"``: the worker skips that one round's exchange but
      stays live and keeps computing.

    Workers start live; the masks depend only on the event list.
    """
    def _fields(e):
        if hasattr(e, "round"):
            return int(e.round), str(e.kind), int(e.worker)
        r, kind, w = e
        return int(r), str(kind), int(w)

    by_round: dict = {}
    for e in events:
        r, kind, w = _fields(e)
        if kind not in ("kill", "revive", "straggle"):
            raise ValueError(f"unknown membership event kind {kind!r}")
        if not (0 <= w < K) or not (0 <= r < n_rounds):
            raise ValueError(f"membership event out of range: {(r, kind, w)}")
        by_round.setdefault(r, []).append((kind, w))

    live = np.ones((n_rounds, K), dtype=bool)
    straggle = np.zeros((n_rounds, K), dtype=bool)
    alive = np.ones(K, dtype=bool)
    for r in range(n_rounds):
        for (kind, w) in by_round.get(r, []):
            if kind == "kill":
                alive[w] = False
            elif kind == "revive":
                alive[w] = True
            else:
                straggle[r, w] = True
        live[r] = alive
    ms = MembershipSchedule("events", live, live & ~straggle)
    ms.validate()
    return ms


def exchanges(top: Topology, axis: Optional[int] = None):
    """``(k, j, w)`` for every exchange between two distinct workers: k
    receives w of j's value.  The weighted shifts then the perms of one
    ``axis``, as :meth:`Topology.structure_matrix` walks them, or of every
    axis in ascending order."""
    grid = top.axis_sizes
    axes = (sorted({ax for (ax, _, _) in top.shifts}
                   | {ax for (ax, _, _) in top.perms})
            if axis is None else [axis])
    for ax in axes:
        n = grid[ax]
        for (a, sh, w) in top.shifts:
            if a != ax or sh == 0:
                continue
            for k in range(top.n_workers):
                idx = list(np.unravel_index(k, grid))
                idx[ax] = (idx[ax] + sh) % n
                j = int(np.ravel_multi_index(idx, grid))
                if j != k:
                    yield k, j, w
        for (a, recv, w) in top.perms:
            if a != ax:
                continue
            for k in range(top.n_workers):
                idx = list(np.unravel_index(k, grid))
                idx[ax] = recv[idx[ax]]
                j = int(np.ravel_multi_index(idx, grid))
                if j != k:
                    yield k, j, w


def masked_matrix(top: Topology, active) -> np.ndarray:
    """A round's mixing matrix with only ``active`` workers exchanging, in
    float64: the structure matrix's per-axis product, each axis factor
    ``A`` masked per worker k::

        A'_kj = A_kj   if k ≠ j and both k and j are active
              = 0      if k ≠ j and either is not
        A'_kk = 1 − Σ_{j≠k} A'_kj      (lost neighbour mass goes to self)

    Every row sums to 1; an inactive worker's row is ``e_k`` and no active
    row reads its column.  For a symmetric base W the result is doubly
    stochastic over the active set.  With every worker active it equals
    ``structure_matrix()``.  The factors multiply as ``W = A @ W``, axis
    by axis in ascending order.
    """
    act = np.asarray(active, dtype=bool)
    K = top.n_workers
    if act.shape != (K,):
        raise ValueError(f"active mask shape {act.shape} != ({K},)")
    axes = sorted({ax for (ax, _, _) in top.shifts}
                  | {ax for (ax, _, _) in top.perms})
    W = np.eye(K)
    for ax in axes:
        A = np.zeros((K, K))
        for (k, j, w) in exchanges(top, ax):
            if act[k] and act[j]:
                A[k, j] += w
        for k in range(K):
            A[k, k] = 1.0 - A[k].sum()
        W = A @ W
    return W


def active_edge_count(top: Topology, active) -> int:
    """Directed exchanges that ship in a round where only ``active``
    workers take part: one per (receiver, source) pair with both ends
    active, per weighted shift or perm.  With everyone active this is
    ``K × degree``."""
    act = np.asarray(active, dtype=bool)
    return sum(1 for (k, j, _w) in exchanges(top) if act[k] and act[j])
