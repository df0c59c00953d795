"""Gossip communication: the dense K-worker simulation backend.

Port of ``src/repro/core/gossip.py:84-373`` and ``:840-875`` for static
graphs.  :class:`DenseComm` keeps every leaf worker-stacked (leading dim K)
and mixes ``x⁽ᵏ⁾ ← Σⱼ w_kj x⁽ʲ⁾`` either as ``W @ flat`` over the worker dim
(:meth:`DenseComm.mix`, the tree path) or, on the kernel path, as shifted
views of the worker grid (:meth:`DenseComm._roll`) fed to the fused AXPY
kernel by the optimizer.

Not in this slice, and refused at construction: time-varying schedules and
membership (ROADMAP queue A item 7), the bf16 wire (queue A item 10) and
the sharded backend (queue A item 12).
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from repro_torch import resolve_device
from repro_torch.core.topology import Topology
from repro_torch.tree import tree_leaves, tree_map

__all__ = ["CommBackend", "DenseComm", "gossip_bytes_per_round"]

ShiftKey = Tuple[int, int]  # (topology axis, shift)


class CommBackend:
    """What an optimizer needs of a gossip backend, for a static graph."""
    topology: Topology
    wire_dtype: str = "float32"

    @property
    def wire_itemsize(self) -> int:
        """Bytes per element of the uncompressed gossip payload."""
        return 2 if self.wire_dtype == "bfloat16" else 4

    @property
    def round_cycle(self) -> int:
        """Rounds after which the graph repeats: 1 for a static graph."""
        return 1

    def topology_at(self, r: int) -> Topology:
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


@dataclasses.dataclass
class DenseComm(CommBackend):
    """Simulation backend: leaves are worker-stacked, leading dim K, on
    ``device``."""

    topology: Topology
    membership: Optional[object] = None
    wire_dtype: str = "float32"
    device: object = "cuda"

    def __post_init__(self):
        if not isinstance(self.topology, Topology):
            raise NotImplementedError(
                "time-varying topology schedules are ROADMAP queue A item 7")
        if self.membership is not None:
            raise NotImplementedError(
                "membership schedules are ROADMAP queue A item 7")
        if self.wire_dtype == "bfloat16":
            raise NotImplementedError(
                "the bf16 gossip wire is ROADMAP queue A item 10")
        if self.wire_dtype != "float32":
            raise ValueError(f"wire_dtype {self.wire_dtype!r} not in "
                             "('float32', 'bfloat16')")
        self.device = resolve_device(self.device)
        self._W = torch.tensor(self.topology.W, dtype=torch.float32,
                               device=self.device)

    def mix(self, tree, r=None):
        """Σⱼ w_kj x⁽ʲ⁾ over the worker dim of every leaf (``r`` is the
        round index, which a static graph ignores)."""
        return self._apply_W(self._W, tree)

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
