"""Plain PyTorch versions of the port's kernels.

The wrappers run these on CPU tensors; the tests hold them against the JAX
oracles in ``repro.kernels.ref`` and ``chip_smoke.py`` holds each CUDA
kernel against them on the card.  Each elementwise op is its own PyTorch
call, so every product and sum is rounded separately — the CUDA kernels
pin the same rounding with ``__fmul_rn``/``__fadd_rn`` and are bit-exact
against these.  Python float scalars (μ, wd, weights) are rounded to f32
by PyTorch, as the kernels' launch arguments are.

The codec rows math lives here once, for the kernels' plain versions and
for the per-leaf codecs of :mod:`repro_torch.core.compression` and
:mod:`repro_torch.core.wire` alike: :func:`tree_sum` (the one summation
order of the sign scale), :func:`qsgd_bits` and the QSGD level arithmetic,
:func:`topk_width` and the top-k select and scatter, and the row gather and
scatter of the sparse-rows wire.
"""
from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.kernels import LANE

__all__ = ["momentum_update_ref", "leaf_matrix_ref", "gossip_mix_ref",
           "gossip_shift_ref", "tree_sum", "qsgd_bits",
           "qsgd_inv_levels", "sign_pack_rows_ref", "sign_unpack_ref",
           "qsgd_rows_ref", "qsgd_rows_unpack_ref", "topk_width",
           "topk_rows_ref", "topk_rows_unpack_ref", "row_gather_ref",
           "row_scatter_ref"]


def momentum_update_ref(x, m, g, lr, *, mu, wd=0.0, nesterov=False):
    """``g' = g + wd·x; m' = μ·m + g'; x' = x − lr·d`` with ``d = m'``
    (Nesterov: ``g' + μ·m'``).  Returns ``(x', m')``."""
    g = g + wd * x
    m_new = mu * m + g
    d = (g + mu * m_new) if nesterov else m_new
    return x - lr * d, m_new


def leaf_matrix_ref(table) -> torch.Tensor:
    """The ``(workers, rows, LANE)`` g that the in-place momentum kernel
    reads through a leaf ``table``
    (:class:`repro_torch.kernels.momentum.LeafTable`): row r of worker k
    from the last leaf that starts at or before r, its element
    ``(r − row_start)·LANE + lane`` of the worker's slice; 0 at or past the
    leaf's size and in rows before the first leaf."""
    k, rows = table.workers, table.rows
    first = table.leaves[0]
    out = torch.zeros((k, rows * LANE), dtype=torch.float32,
                      device=first.device)
    ends = table.row_starts[1:] + (rows,)
    for leaf, size, start, end in zip(table.leaves, table.sizes,
                                      table.row_starts, ends):
        n = min(size, (end - start) * LANE)
        out[:, start * LANE:start * LANE + n] = leaf.reshape(k, -1)[:, :n]
    return out.view(k, rows, LANE)


def gossip_mix_ref(tensors, weights):
    """``y = w₀·x₀ + w₁·x₁ + …`` accumulated left to right.  Starts from
    ``w₀·x₀`` as the Pallas kernel body does (the JAX oracle adds it to a
    zero, which differs only in the sign of a zero result)."""
    acc = weights[0] * tensors[0]
    for w, t in zip(weights[1:], tensors[1:]):
        acc = acc + w * t
    return acc


def _shift_view_ref(x, *, grid, axis: int, shift: int, lim: int):
    """The view of ``x`` (K, rows, d) that worker k receives from the
    worker ``shift`` further along ``axis`` of the row-major worker
    ``grid``, as the wire ships it: rows cut to ``lim``, the worker grid
    rolled (``DenseComm._roll``), the cut rows padded back with +0.0
    (``KernelPlan.wire`` and ``pad_wire``)."""
    rows = x.shape[-2]
    v = x[..., :lim, :] if lim < rows else x
    g = torch.roll(v.reshape(tuple(grid) + tuple(v.shape[1:])), -shift,
                   dims=axis)
    v = g.reshape(v.shape)
    return F.pad(v, (0, 0, 0, rows - lim)) if lim < rows else v


def gossip_shift_ref(x, shifts, weights, *, grid, axis: int, lim: int,
                     nbr=None):
    """One topology axis of a shift graph: the self view (shift 0) is
    ``x`` itself, every other view is :func:`_shift_view_ref` of ``nbr``
    (``x`` by default; the bf16 wire passes the payload's f32 round trip),
    and the views are summed by :func:`gossip_mix_ref` in ``shifts``
    order."""
    src = x if nbr is None else nbr
    views = [x if sh == 0 else _shift_view_ref(src, grid=grid, axis=axis,
                                               shift=sh, lim=lim)
             for sh in shifts]
    return gossip_mix_ref(views, weights)


def tree_sum(x: torch.Tensor) -> torch.Tensor:
    """Sum over the last axis as a fixed balanced binary tree: neighbours
    first, then neighbouring pairs, and so on (zero-padded to a power of
    two).  The reference's Pallas sign kernel sums with ``jnp.sum``, whose
    order is not pinned; the port pins this one in the plain version, the
    per-leaf codec and the CUDA kernel alike, so all three agree bit for
    bit."""
    n = x.shape[-1]
    p = 1 << max(n - 1, 0).bit_length()
    if p != n:
        x = F.pad(x, (0, p - n))
    while x.shape[-1] > 1:
        x = x[..., 0::2] + x[..., 1::2]
    return x[..., 0]


def _pack_fields(u: torch.Tensor, bits: int) -> torch.Tensor:
    """(R, B) u8 fields of ``bits`` bits → (R, B·bits/8) u8, element ``i``
    of each group of ``8/bits`` at bit ``bits·i`` (LSB first)."""
    vpb = 8 // bits
    shifts = bits * torch.arange(vpb, dtype=torch.uint8, device=u.device)
    grouped = u.reshape(u.shape[0], -1, vpb) << shifts
    return grouped.sum(-1).to(torch.uint8)


def _unpack_fields(packed: torch.Tensor, bits: int) -> torch.Tensor:
    """Inverse of :func:`_pack_fields`: (R, W) u8 → (R, W·8/bits) u8."""
    vpb = 8 // bits
    shifts = bits * torch.arange(vpb, dtype=torch.uint8, device=packed.device)
    fields = (packed[:, :, None] >> shifts) & ((1 << bits) - 1)
    return fields.reshape(packed.shape[0], -1)


def sign_pack_rows_ref(x, counts):
    """x (R, B) f32, counts (R, 1) f32 valid elements per row → ``(packed
    (R, B/8) u8, scales (R, 1) f32)``: ``scale = tree_sum(|x|) /
    max(count, 1)`` (padding lanes are zero, so only the divisor needs the
    count); bit ``x ≥ 0`` (−0.0 and padding pack as 1)."""
    scales = tree_sum(x.abs()) / torch.clamp(counts.reshape(-1), min=1.0)
    packed = _pack_fields((x >= 0).to(torch.uint8), 1)
    return packed, scales.reshape(-1, 1)


def sign_unpack_ref(packed, scales):
    """(R, B/8) u8, (R, 1) f32 → (R, B) f32 ``(2·bit − 1)·scale``: a zero
    scale decodes to ±0 by the bit."""
    signs = _unpack_fields(packed, 1).to(torch.float32) * 2.0 - 1.0
    return signs * scales.reshape(-1, 1)


def qsgd_bits(levels: int) -> int:
    """Bits per element packing the 2·levels+1 symmetric quantization
    levels: the smallest divisor of 8 that holds them (so whole elements
    pack into bytes)."""
    need = 2 * levels + 1
    for b in (2, 4, 8):
        if (1 << b) >= need:
            return b
    raise ValueError(f"qsgd levels={levels} needs > 8 bits; use ≤ 127")


def qsgd_inv_levels(levels: int) -> float:
    """``1/s`` as the f32 the reference precomputes (``np.float32(1) /
    np.float32(levels)``), held in a Python float that converts to that f32
    exactly."""
    return float(np.float32(1.0) / np.float32(levels))


def qsgd_rows_ref(x, levels: int):
    """x (R, B) f32 → ``(packed (R, B·bits/8) u8, norms (R, 1) f32)``:
    ``norm = max|x|``; ``u = rint(x·(s / max(norm, 1e-30))) + s`` with
    round-half-even, packed ``8/bits`` per byte."""
    bits = qsgd_bits(levels)
    s = float(levels)
    norms = x.abs().amax(dim=1, keepdim=True)
    # a tensor divided by a tensor: PyTorch computes ``scalar / tensor``
    # as ``reciprocal(tensor) · scalar``, which is not the IEEE quotient
    qscale = torch.full_like(norms, s) / torch.clamp(norms, min=1e-30)
    u = (torch.round(x * qscale) + s).to(torch.uint8)
    return _pack_fields(u, bits), norms


def qsgd_rows_unpack_ref(packed, norms, levels: int):
    """Inverse of :func:`qsgd_rows_ref` → (R, B) f32 ``(u − s)·(inv_s·norm)``
    with ``inv_s`` the reference's f32 reciprocal, then ``+0`` where
    ``norm ≤ 0``."""
    u = _unpack_fields(packed, qsgd_bits(levels))
    norms = norms.reshape(-1, 1)
    scale = qsgd_inv_levels(levels) * norms
    vals = (u.to(torch.float32) - float(levels)) * scale
    return torch.where(norms > 0, vals, 0.0)


def topk_width(fraction: float, block: int) -> int:
    """Top-k payload slots per row, ``max(1, ceil(fraction·block))`` in
    float64 as the reference computes it: uniform across rows and leaves,
    so payload matrices are rectangular."""
    return max(1, int(np.ceil(fraction * block)))


def topk_rows_ref(x, counts=None, *, fraction: float, width=None):
    """x (R, B) f32, counts (R, 1) f32 valid elements per row (None: full
    rows) → ``(idx (R, W) i32, vals (R, W) f32)``.  Slot j holds the j-th
    largest |x| of the row, ties to the lowest index, while ``j <
    ceil(f32(fraction)·count)`` (the product rounded in f32, as the
    reference's ``jnp.float32(fraction) * counts``), and ``(0, 0.0)``
    after.  ``vals`` are x as read, so a selected −0.0 stays −0.0 (the
    reference's ``take_along_axis`` oracle; its Pallas kernel sums the row
    and returns +0.0).  ``torch.topk`` promises no tie order, so the order
    is a stable descending sort."""
    rows, block = x.shape
    w = width if width is not None else topk_width(fraction, block)
    order = torch.sort(x.abs(), dim=1, descending=True, stable=True)[1]
    idx = order[:, :w]
    vals = torch.gather(x, 1, idx)
    if counts is None:
        counts = torch.full((rows, 1), float(block), dtype=torch.float32,
                            device=x.device)
    frac = torch.tensor(np.float32(fraction), device=x.device)
    k_active = torch.ceil(counts.reshape(rows, 1) * frac).to(torch.int32)
    active = torch.arange(w, dtype=torch.int32, device=x.device) < k_active
    return (torch.where(active, idx, 0).to(torch.int32),
            torch.where(active, vals, 0.0))


def topk_rows_unpack_ref(idx, vals, block: int):
    """Inverse of :func:`topk_rows_ref` → (R, block) f32: ``+0.0`` rows
    with ``out[idx_j] += val_j``.  Placeholder slots ``(0, 0.0)`` add
    nothing, and the add turns a −0.0 value into +0.0.  On CUDA the add
    flushes subnormal inputs and sums to zero, as the kernel and XLA do;
    on the CPU it keeps them."""
    out = torch.zeros((idx.shape[0], block), dtype=torch.float32,
                      device=vals.device)
    return out.scatter_add(1, idx.long(), vals)


def _source_rows(idx, rows: int):
    """(K, S) row indices into K stacked blocks of ``rows`` rows → flat
    (K·S,) int64 indices into the (K·rows) folded rows."""
    k = idx.shape[0]
    base = rows * torch.arange(k, device=idx.device).reshape(k, 1)
    return (idx.long() + base).reshape(-1)


def row_gather_ref(x, idx, counts=None):
    """x (K, rows, B) f32, idx (K, S) int, counts (K·rows, 1) f32 (None:
    full rows) → (K, S, B) f32 with ``out[k, j] = x[k, idx[k, j]]`` and
    lanes ≥ that row's count set to +0.0; the kept lanes are moved as they
    are (−0.0 included)."""
    k, rows, block = x.shape
    src = _source_rows(idx, rows)
    g = x.reshape(-1, block).index_select(0, src)
    if counts is not None:
        cnt = counts.reshape(-1).index_select(0, src).reshape(-1, 1)
        lanes = torch.arange(block, dtype=torch.float32, device=x.device)
        g = torch.where(lanes < cnt, g, 0.0)
    return g.reshape(k, idx.shape[1], block)


def row_scatter_ref(idx, vals, *, rows: int):
    """idx (K, S) int, vals (K, S, B) f32 → (K, rows, B) f32: zeros with
    ``out[k, idx[k, j]] += vals[k, j]``, so a −0.0 lands as +0.0.  The
    indices of a worker must be distinct (and are sorted, as the sparse
    codec selects them); on the CPU that is checked."""
    k, s, block = vals.shape
    if idx.device.type == "cpu" and s > 1 and not bool(
            (idx[:, 1:] > idx[:, :-1]).all()):
        raise ValueError("row_scatter: each worker's indices must be "
                         "distinct and sorted ascending")
    out = torch.zeros((k * rows, block), dtype=torch.float32,
                      device=vals.device)
    out.index_add_(0, _source_rows(idx, rows), vals.reshape(-1, block))
    return out.reshape(k, rows, block)
