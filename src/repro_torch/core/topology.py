"""Static gossip topologies and their mixing matrices (numpy only).

Port of ``src/repro/core/topology.py:114-259``.  A topology holds a
doubly-stochastic mixing matrix ``W`` over K workers (paper §3.2,
Assumption 1) and its neighbour structure: weighted circulant shifts per
worker-grid axis, which the kernel path turns into shifted views mixed by
the fused AXPY.  Time-varying schedules, membership and hierarchical
graphs are ROADMAP queue A items 7 and 10.
"""
from __future__ import annotations

import dataclasses
from typing import Sequence

import numpy as np

__all__ = ["Topology", "ring", "torus", "complete"]


@dataclasses.dataclass(frozen=True)
class Topology:
    """A gossip graph over ``n_workers`` with doubly-stochastic weights.

    Attributes:
      name: identifier ("ring", "torus", "complete").
      W: dense (K, K) mixing matrix, numpy float64.
      shifts: ((axis, shift, weight), ...) — the neighbour exchange
        pattern; ``axis`` indexes ``axis_sizes`` and shift 0 is the self
        weight.
      axis_sizes: worker-grid shape whose product is K.
      symmetric: whether W is symmetric.
    """

    name: str
    W: np.ndarray
    shifts: tuple
    axis_sizes: tuple
    symmetric: bool = True

    @property
    def n_workers(self) -> int:
        return int(self.W.shape[0])

    @property
    def degree(self) -> int:
        """Non-self exchanges per worker per round: what the bytes on the
        wire scale with."""
        return sum(1 for (_, s, _) in self.shifts if s != 0)

    def self_weight(self) -> float:
        return float(self.W[0, 0])

    def structure_matrix(self) -> np.ndarray:
        """Dense W rebuilt from the shift structure, applied per axis in
        order — what the shifted-view AXPY executes."""
        grid = self.axis_sizes
        K = self.n_workers
        axes = sorted({ax for (ax, _, _) in self.shifts})
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
            W = A @ W
        return W


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
