"""The flatten-once kernel layout (``KernelPlan``) and the matrix wrappers.

Port of ``src/repro/kernels/ops.py:54-338``.  Every kernel works on one
layout: an f32 matrix of shape ``(rows, 1024)``, or ``(K, rows, 1024)``
with a leading worker dim.  ``KernelPlan`` maps a flat param dict onto it:

  * each leaf starts on a fresh row and its tail row is zero-padded, so a
    row never spans two leaves and the zero tail keeps the elementwise
    kernels exact;
  * leaves take rows in the reference's leaf order
    (:func:`repro_torch.tree.leaf_order`), so row starts, ``row_counts``
    and the wire extent equal the reference's;
  * rows are padded up to ``PLAN_BLOCK_ROWS``, and ``used_rows`` is the
    extent that carries leaf data — what the wire ships.

``unflatten`` returns views into the matrix (no copy); ``flatten`` writes
each leaf into a zeroed matrix (one copy per leaf).  A tree that one
in-place momentum launch reads once (PD-SGDM's gradient) need not be
flattened at all: :class:`Leaves` hands it over as it lies, and the launch
reads each leaf through :meth:`KernelPlan.leaf_table`.
"""
from __future__ import annotations

import dataclasses
from typing import Tuple

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.kernels import LANE
from repro_torch.kernels import qsgd_quant as qq
from repro_torch.kernels import row_gather as rg
from repro_torch.kernels import sign_compress as sc
from repro_torch.kernels import topk_select as tk
from repro_torch.kernels.gossip_mix import gossip_mix, gossip_mix_shifted
from repro_torch.kernels.momentum import (MAX_LEAVES, LeafTable, leaf_table,
                                          momentum_update)
from repro_torch.spans import LAYOUT_FLATTEN, LAYOUT_UNFLATTEN, span
from repro_torch.tree import leaf_order

__all__ = ["KernelPlan", "Leaves", "PLAN_BLOCK_ROWS", "LANE", "as_matrix",
           "momentum_update_mat",
           "gossip_mix_mat", "gossip_mix_shifted", "delayed_mix_mat",
           "tile_counts", "sign_pack", "sign_unpack", "qsgd_pack",
           "qsgd_unpack", "topk_pack", "topk_unpack", "row_gather",
           "row_scatter"]

# The reference pads rows to the lcm of its Pallas kernels' BLOCK_ROWS
# (128 and 256); the port keeps that value so both layouts have equal rows.
PLAN_BLOCK_ROWS = 256


@dataclasses.dataclass(frozen=True)
class _Slot:
    """Where one leaf lives in the (rows, 1024) matrix."""
    shape: Tuple[int, ...]     # per-worker shape (worker dim stripped)
    dtype: torch.dtype
    size: int                  # prod(shape)
    row_start: int
    n_rows: int                # ceil(size / 1024)


@dataclasses.dataclass(frozen=True)
class KernelPlan:
    """Flatten-once mapping: flat param dict ⇄ zero-padded (rows, 1024) f32.

    ``worker_dim=True`` treats each leaf's leading axis as the stacked
    worker dim: ``flatten`` returns ``(K, rows, 1024)`` with the same row
    layout for every worker.
    """
    names: Tuple[str, ...]
    slots: Tuple[_Slot, ...]
    rows: int
    block_rows: int
    worker_dim: bool

    @classmethod
    def for_tree(cls, tree: dict, *, worker_dim: bool = False,
                 block_rows: int = PLAN_BLOCK_ROWS) -> "KernelPlan":
        """Build a plan from a flat dict of tensors (any device, or meta)."""
        names = tuple(leaf_order(tree))
        slots = []
        row = 0
        for name in names:
            leaf = tree[name]
            shape = tuple(leaf.shape[1:] if worker_dim else leaf.shape)
            size = int(np.prod(shape)) if shape else 1
            if size <= 0:
                raise ValueError(f"empty leaf {name} {tuple(leaf.shape)} has "
                                 "no kernel rows")
            n_rows = -(-size // LANE)
            slots.append(_Slot(shape, leaf.dtype, size, row, n_rows))
            row += n_rows
        rows = -(-row // block_rows) * block_rows
        return cls(names, tuple(slots), rows, block_rows, worker_dim)

    # -- geometry ----------------------------------------------------------
    @property
    def n_valid(self) -> int:
        """Total real (non-padding) elements per worker."""
        return sum(s.size for s in self.slots)

    @property
    def used_rows(self) -> int:
        """Rows that carry leaf data: the wire extent.  Payloads are sliced
        to it before a neighbour exchange, so the bytes shipped equal the
        accounted ``Σ ceil(size/1024)`` rows."""
        last = self.slots[-1]
        return last.row_start + last.n_rows

    def pad_wire(self, mat: torch.Tensor) -> torch.Tensor:
        """Re-pad a wire-sliced ``(..., used_rows, d)`` payload with zero
        rows back to ``(..., rows, d)``."""
        return F.pad(mat, (0, 0, 0, self.rows - mat.shape[-2]))

    def wire(self, mat: torch.Tensor) -> torch.Tensor:
        """Slice a kernel matrix to the ``used_rows`` wire extent (a view;
        the identity when the alignment tail is empty).  The tail is zero on
        every worker and row-local mixing keeps it zero, so this is exact."""
        if self.used_rows >= self.rows:
            return mat
        return mat[..., :self.used_rows, :]

    def row_counts(self, device=None) -> torch.Tensor:
        """(rows, 1) f32 on ``device`` (the CPU by default): valid elements
        per row, the sign-scale divisor of the compressed wire.  Built on
        the host, so each call on a card copies it over: callers on the
        round's path keep one device copy per plan (see
        :func:`tile_counts`)."""
        c = np.zeros((self.rows,), np.float32)
        for s in self.slots:
            c[s.row_start:s.row_start + s.n_rows] = float(LANE)
            c[s.row_start + s.n_rows - 1] = float(
                s.size - (s.n_rows - 1) * LANE)
        return torch.from_numpy(c).reshape(self.rows, 1).to(device)

    # -- tree ⇄ matrix -----------------------------------------------------
    def flatten(self, tree: dict) -> torch.Tensor:
        """(rows, 1024) f32 — or (K, rows, 1024) when ``worker_dim`` — on
        the leaves' device."""
        first = tree[self.names[0]]
        lead = (first.shape[0],) if self.worker_dim else ()
        with span(LAYOUT_FLATTEN):
            mat = torch.zeros(lead + (self.rows, LANE), dtype=torch.float32,
                              device=first.device)
            for name, slot in zip(self.names, self.slots):
                block = mat[..., slot.row_start:slot.row_start
                            + slot.n_rows, :]
                block.view(lead + (-1,))[..., :slot.size].copy_(
                    tree[name].reshape(lead + (-1,)))
        return mat

    def leaf_table(self, tree: dict) -> LeafTable:
        """The momentum kernel's table of ``tree``'s leaves on this layout
        (:func:`repro_torch.kernels.momentum.leaf_table`): each leaf read
        where it lies, from its slot's first row, or copied on its own
        first where the kernel cannot read it there."""
        first = tree[self.names[0]]
        lead = (first.shape[0],) if self.worker_dim else ()
        leaves = []
        for name, slot in zip(self.names, self.slots):
            leaf = tree[name]
            if tuple(leaf.shape) != lead + slot.shape:
                raise ValueError(f"leaf {name}: shape {tuple(leaf.shape)}, "
                                 f"the plan's {lead + slot.shape}")
            leaves.append(leaf)
        return leaf_table(leaves, [s.row_start for s in self.slots],
                          workers=lead[0] if lead else 1, rows=self.rows)

    def unflatten(self, mat: torch.Tensor, dtype=None) -> dict:
        """Inverse of :meth:`flatten`, as views into ``mat`` where the leaf
        dtype is f32; ``dtype`` overrides the recorded per-leaf dtypes."""
        lead = (mat.shape[0],) if self.worker_dim else ()
        out = {}
        with span(LAYOUT_UNFLATTEN):
            for name, slot in zip(self.names, self.slots):
                block = mat[..., slot.row_start:slot.row_start
                            + slot.n_rows, :]
                flat = block.view(lead + (-1,))[..., :slot.size]
                out[name] = flat.view(lead + slot.shape).to(
                    dtype or slot.dtype)
        return out


@dataclasses.dataclass(frozen=True, eq=False)
class Leaves:
    """A tree handed to a kernel on ``plan``'s layout as its leaves lie:
    what ``plan.flatten(tree)`` would make, not yet made.  The in-place
    momentum launch reads it through ``plan.leaf_table``; every other
    consumer takes :func:`as_matrix`, the flatten."""
    plan: KernelPlan
    tree: dict


def as_matrix(g) -> torch.Tensor:
    """``g`` as a kernel matrix: :class:`Leaves` flattened (one copy a
    leaf), a matrix as it is."""
    return g.plan.flatten(g.tree) if isinstance(g, Leaves) else g


def _rows2d(mat: torch.Tensor) -> torch.Tensor:
    """Collapse any leading worker dims onto the row axis: (..., R, 1024) →
    (N·R, 1024).  The kernels are elementwise, so rows of two workers may
    share a block."""
    return mat.reshape(-1, LANE)


# --------------------------------------------------------------------- mat ops
def momentum_update_mat(x_mat, m_mat, g_mat, *, mu: float, lr,
                        weight_decay: float = 0.0, nesterov: bool = False,
                        inplace: bool = False):
    """Fused SGDM on the kernel layout; accepts (..., rows, 1024).  With
    ``inplace`` the update is written over ``x_mat`` and ``m_mat`` (folded
    onto rows as views), which are returned.  ``g_mat`` may be
    :class:`Leaves` of x's plan: the in-place launch reads each leaf
    where it lies, through the plan's leaf table; out of place, or past
    the ``MAX_LEAVES`` one launch's table holds, they are flattened
    first."""
    if isinstance(g_mat, Leaves):
        g_mat = (g_mat.plan.leaf_table(g_mat.tree)
                 if inplace and len(g_mat.plan.names) <= MAX_LEAVES
                 else as_matrix(g_mat))
    if inplace:
        g = g_mat if isinstance(g_mat, LeafTable) else _rows2d(g_mat)
        momentum_update(x_mat.view(-1, LANE), m_mat.view(-1, LANE),
                        g, lr, mu=mu, wd=weight_decay,
                        nesterov=nesterov, inplace=True)
        return x_mat, m_mat
    shape = x_mat.shape
    x_new, m_new = momentum_update(
        _rows2d(x_mat), _rows2d(m_mat), _rows2d(g_mat), lr, mu=mu,
        wd=weight_decay, nesterov=nesterov)
    return x_new.reshape(shape), m_new.reshape(shape)


def gossip_mix_mat(mats, weights):
    """Fused W-row AXPY of n aligned matrices; accepts (..., rows, 1024)."""
    shape = mats[0].shape
    out = gossip_mix(tuple(_rows2d(m) for m in mats),
                     weights=tuple(float(w) for w in weights))
    return out.reshape(shape)


def delayed_mix_mat(x_mat, dx_mat):
    """Land an overlapped round's one-round-stale correction on the
    matrix: ``x + dx`` as the fused AXPY with weights (1, 1)."""
    return gossip_mix_mat((x_mat, dx_mat), (1.0, 1.0))


def tile_counts(counts: torch.Tensor, rows: int, lead) -> torch.Tensor:
    """The ``(N·rows, 1)`` counts operand of a ``(*lead, rows, 1024)``
    matrix folded onto rows (N = prod(lead)): ``counts`` of ``rows``
    elements is tiled over the leading worker dims (the per-row layout is
    the same for every worker); one of ``N·rows`` elements is taken as
    already tiled.  Port of ``_tile_counts`` (reference ``ops.py:243``)."""
    n = int(np.prod(tuple(lead), dtype=np.int64))
    c = counts.reshape(-1, 1)
    if c.shape[0] == rows and n != 1:
        c = c.repeat(n, 1)
    if c.shape[0] != n * rows:
        raise ValueError(f"counts of {counts.numel()} rows for {n} × {rows} "
                         "kernel rows")
    return c


def sign_pack(x_mat, counts):
    """(..., rows, 1024) → (packed (..., rows, 128) u8, scales
    (..., rows, 1) f32).  ``counts``: per-row valid lengths on the
    matrix's device, per worker or tiled (:func:`tile_counts`)."""
    lead, rows = x_mat.shape[:-2], x_mat.shape[-2]
    packed, scales = sc.sign_pack(_rows2d(x_mat),
                                  tile_counts(counts, rows, lead))
    return (packed.reshape(lead + (rows, sc.PACKED)),
            scales.reshape(lead + (rows, 1)))


def sign_unpack(packed, scales):
    """Inverse of :func:`sign_pack`: (..., rows, 1024) f32 = scale·sign."""
    lead, rows = packed.shape[:-2], packed.shape[-2]
    out = sc.sign_unpack(packed.reshape(-1, sc.PACKED), scales.reshape(-1, 1))
    return out.reshape(lead + (rows, LANE))


def qsgd_pack(x_mat, *, levels: int):
    """(..., rows, 1024) → (levels (..., rows, 1024·bits/8) u8, norms
    (..., rows, 1) f32): the blockwise QSGD wire payload."""
    lead, rows = x_mat.shape[:-2], x_mat.shape[-2]
    packed, norms = qq.qsgd_quant(_rows2d(x_mat), levels=levels)
    return (packed.reshape(lead + (rows, packed.shape[-1])),
            norms.reshape(lead + (rows, 1)))


def qsgd_unpack(packed, norms, *, levels: int):
    """Inverse of :func:`qsgd_pack`: (..., rows, 1024) f32."""
    lead, rows = packed.shape[:-2], packed.shape[-2]
    out = qq.qsgd_dequant(packed.reshape(-1, packed.shape[-1]),
                          norms.reshape(-1, 1), levels=levels)
    return out.reshape(lead + (rows, LANE))


def topk_pack(x_mat, counts=None, *, fraction: float):
    """(..., rows, 1024) → (idx (..., rows, W) i32, vals (..., rows, W)
    f32), W = ``max(1, ceil(fraction·1024))``: the blockwise top-k wire
    payload.  ``counts``: per-row valid lengths, per worker or tiled
    (:func:`tile_counts`); None for full rows."""
    lead, rows = x_mat.shape[:-2], x_mat.shape[-2]
    if counts is not None:
        counts = tile_counts(counts, rows, lead)
    idx, vals = tk.topk_select(_rows2d(x_mat), counts, fraction=fraction)
    w = idx.shape[-1]
    return idx.reshape(lead + (rows, w)), vals.reshape(lead + (rows, w))


def topk_unpack(idx, vals):
    """Inverse scatter of :func:`topk_pack` → (..., rows, 1024) f32."""
    lead, rows, w = idx.shape[:-2], idx.shape[-2], idx.shape[-1]
    out = tk.topk_scatter(idx.reshape(-1, w), vals.reshape(-1, w))
    return out.reshape(lead + (rows, LANE))


def row_gather(x_mat, idx, counts=None):
    """(..., rows, 1024) + idx (..., S) i32 → (..., S, 1024) f32: the
    sparse wire's payload rows, each cut to its valid prefix.  ``counts``:
    per-row valid lengths, per worker or tiled (:func:`tile_counts`); None
    for full rows.  All leading worker dims go to one launch (the
    reference launches once per worker)."""
    lead, rows = x_mat.shape[:-2], x_mat.shape[-2]
    k = int(np.prod(tuple(lead), dtype=np.int64))
    if counts is not None:
        counts = tile_counts(counts, rows, lead)
    out = rg.row_gather(x_mat.reshape(k, rows, LANE),
                        idx.reshape(k, idx.shape[-1]), counts)
    return out.reshape(lead + out.shape[-2:])


def row_scatter(idx, vals, *, rows: int):
    """Inverse of :func:`row_gather`: idx (..., S) + vals (..., S, 1024) →
    (..., rows, 1024) f32, zeros with ``out[idx[j]] += vals[j]`` per
    worker, in one launch."""
    lead, s = vals.shape[:-2], vals.shape[-2]
    k = int(np.prod(tuple(lead), dtype=np.int64))
    out = rg.row_scatter(idx.reshape(k, s), vals.reshape(k, s, LANE),
                         rows=rows)
    return out.reshape(lead + (rows, LANE))
