"""Fused SGDM update:  m ← μ·m + (g + wd·x);  x ← x − lr·d.

Port of the Pallas kernel ``repro.kernels.momentum.momentum_update``
(``src/repro/kernels/momentum.py:32-66``), the memory-bound inner loop of
PD-SGDM's local step.  On CUDA tensors :func:`momentum_update` launches
the hand-written kernel in ``csrc/momentum.cu`` (5 streams: x, m, g read
once, x', m' written once); on CPU tensors it runs
:func:`repro_torch.kernels.ref.momentum_update_ref`.

``lr`` is a one-element f32 tensor on the operands' device that the kernel
reads through a pointer, so a learning-rate schedule costs no host sync.

``inplace=True`` writes x' and m' over ``x`` and ``m`` (the C entry
``momentum_update_leaves_f32``, the same arithmetic and bytes): a
caller whose x and m belong to it alone saves two fresh buffers, a copy of
the params each.  There ``g`` may be a :class:`LeafTable` instead of a
matrix: the gradient's leaves, each read where it lies, with no matrix
built for them (:func:`leaf_table`), at most ``MAX_LEAVES`` of them, in
one launch; a matrix is the one-entry table.  On
CPU tensors the in-place form copies the plain version's result into
``x`` and ``m``, a table's leaves laid out as the kernel reads them
(:func:`repro_torch.kernels.ref.leaf_matrix_ref`).  Both forms count
their kernel launches in ``momentum_update.launches``; the table's leaves
count in ``momentum_update.leaf_reads`` (read in place) and
``momentum_update.leaf_copies`` (copied first: not contiguous, not f32,
or a worker's slice not 16-byte aligned).
"""
from __future__ import annotations

import ctypes
import dataclasses

import torch

from repro_torch.kernels import LANE
from repro_torch.kernels import build
from repro_torch.kernels._check import check_matrix, plain_route
from repro_torch.kernels.ref import leaf_matrix_ref, momentum_update_ref

__all__ = ["momentum_update", "LeafTable", "leaf_table", "MAX_LEAVES",
           "LANE"]

_ARGTYPES = ([ctypes.c_void_p] * 6
             + [ctypes.c_longlong, ctypes.c_float, ctypes.c_float,
                ctypes.c_int, ctypes.c_void_p])
_LONGS = ctypes.POINTER(ctypes.c_longlong)
_LEAVES_ARGTYPES = ([ctypes.c_void_p] * 3
                    + [ctypes.c_longlong, ctypes.c_longlong,
                       ctypes.POINTER(ctypes.c_void_p), _LONGS, _LONGS,
                       _LONGS, ctypes.c_int, ctypes.c_float, ctypes.c_float,
                       ctypes.c_int, ctypes.c_void_p])
# the leaves one launch's table holds (``kMaxLeaves`` in momentum.cu)
MAX_LEAVES = 64


@dataclasses.dataclass(frozen=True, eq=False)
class LeafTable:
    """g of a ``(workers, rows, LANE)`` layout as the leaves it is made of.

    Leaf j is a contiguous f32 tensor of ``workers`` slices of
    ``strides[j]`` elements; its first ``sizes[j]`` elements a worker fill
    kernel rows ``row_starts[j]`` on (ascending), ``LANE`` a row.  A row
    reads the last leaf that starts at or before it; lanes past that
    leaf's size, and rows before the first leaf, read 0 — as the zeroed
    matrix of ``KernelPlan.flatten`` holds them.  ``copies``: the leaves
    :func:`leaf_table` had to copy."""
    leaves: tuple
    strides: tuple
    sizes: tuple
    row_starts: tuple
    workers: int
    rows: int
    copies: int = 0


def _in_place(leaf: torch.Tensor, size: int) -> bool:
    """Whether the kernel can read ``leaf`` where it lies: contiguous f32,
    a worker's ``size`` elements a multiple of 4 (16-byte aligned slices),
    and on a card its first byte 16-byte aligned."""
    return (leaf.dtype == torch.float32 and leaf.is_contiguous()
            and size % 4 == 0
            and (leaf.device.type != "cuda" or leaf.data_ptr() % 16 == 0))


def leaf_table(leaves, row_starts, *, workers: int, rows: int) -> LeafTable:
    """The table of ``leaves`` (each of ``workers`` equal slices: a
    worker-stacked ``(workers, ...)`` leaf, or any leaf at 1) from kernel
    rows ``row_starts``.  A leaf the kernel cannot read in place
    (:func:`_in_place`) is copied on its own into a zero-padded
    ``(workers, size rounded up to 4)`` f32 tensor first; the padding reads
    as the zeros the kernel gives lanes past a leaf."""
    out, strides, sizes, copies = [], [], [], 0
    for leaf in leaves:
        size = leaf.numel() // workers
        if not _in_place(leaf, size):
            padded = -(-size // 4) * 4
            buf = torch.empty((workers, padded), dtype=torch.float32,
                              device=leaf.device)
            if padded > size:
                buf[:, size:].zero_()
            buf[:, :size].view(leaf.shape).copy_(leaf)
            leaf, size, copies = buf, padded, copies + 1
        out.append(leaf)
        strides.append(leaf.numel() // workers)
        sizes.append(size)
    return LeafTable(tuple(out), tuple(strides), tuple(sizes),
                     tuple(int(r) for r in row_starts), int(workers),
                     int(rows), copies)


def _overlap(a: torch.Tensor, b: torch.Tensor) -> bool:
    """Whether the bytes of contiguous ``a`` and ``b`` overlap."""
    a0, b0 = a.data_ptr(), b.data_ptr()
    return (a0 < b0 + b.numel() * b.element_size()
            and b0 < a0 + a.numel() * a.element_size())


def momentum_update(x, m, g, lr, *, mu: float, wd: float = 0.0,
                    nesterov: bool = False, inplace: bool = False):
    """x, m: (rows, LANE) f32; g: the same, or with ``inplace`` a
    :class:`LeafTable` of ``rows`` (its workers' rows folded); lr:
    one-element f32 tensor on the same device.  Returns fresh
    ``(x_new, m_new)``, or with ``inplace`` the update written over ``x``
    and ``m`` and returns ``(x, m)``; ``x``, ``m`` and ``g`` must then not
    overlap."""
    table = g if isinstance(g, LeafTable) else None
    check_matrix(x, "x")
    check_matrix(m, "m", like=x)
    if table is None:
        check_matrix(g, "g", like=x)
        gs = (g,)
    else:
        if not inplace:
            raise ValueError("momentum_update: a LeafTable g is read by the "
                             "in-place launch only")
        if table.workers * table.rows != x.shape[0]:
            raise ValueError(f"momentum_update: a table of {table.workers} "
                             f"× {table.rows} rows for x of {x.shape[0]}")
        if len(table.leaves) > MAX_LEAVES:
            raise ValueError(f"momentum_update: a table of "
                             f"{len(table.leaves)} leaves, more than one "
                             f"launch holds ({MAX_LEAVES})")
        gs = table.leaves
        for leaf in gs:
            if leaf.device != x.device:
                raise ValueError(f"g: a leaf on {leaf.device}, expected "
                                 f"{x.device}")
    if not (isinstance(lr, torch.Tensor) and lr.dtype == torch.float32
            and lr.numel() == 1 and lr.device == x.device):
        raise TypeError("lr must be a one-element float32 tensor on "
                        f"{x.device}")
    # a meta tensor has no bytes to overlap (every data_ptr is 0)
    if inplace and x.device.type != "meta" and (
            _overlap(x, m) or any(_overlap(x, t) or _overlap(m, t)
                                  for t in gs)):
        raise ValueError("momentum_update(inplace=True): x, m and g must "
                         "not overlap")
    if plain_route(x):
        if table is not None:
            g = leaf_matrix_ref(table).view(-1, LANE)
        x_new, m_new = momentum_update_ref(x, m, g, lr, mu=mu, wd=wd,
                                           nesterov=nesterov)
        if not inplace:
            return x_new, m_new
        return x.copy_(x_new), m.copy_(m_new)
    lr = lr.contiguous()
    if not inplace:
        fn = build.load_function("momentum", "momentum_update_f32",
                                 _ARGTYPES)
        x_out = torch.empty_like(x)
        m_out = torch.empty_like(m)
        with torch.cuda.device(x.device):
            err = fn(x.data_ptr(), m.data_ptr(), g.data_ptr(), lr.data_ptr(),
                     x_out.data_ptr(), m_out.data_ptr(), x.numel(), mu, wd,
                     int(bool(nesterov)),
                     torch.cuda.current_stream().cuda_stream)
        if err:
            raise RuntimeError(f"momentum_update launch failed: CUDA error "
                               f"{err}")
        momentum_update.launches += 1
        return x_out, m_out
    if table is None:       # a matrix: the one-entry table over every row
        table = LeafTable((g,), (0,), (g.numel(),), (0,), 1, x.shape[0])
    n = len(table.leaves)
    fn = build.load_function("momentum", "momentum_update_leaves_f32",
                             _LEAVES_ARGTYPES)
    with torch.cuda.device(x.device):
        err = fn(x.data_ptr(), m.data_ptr(), lr.data_ptr(), table.workers,
                 table.rows,
                 (ctypes.c_void_p * n)(*(t.data_ptr() for t in table.leaves)),
                 (ctypes.c_longlong * n)(*table.strides),
                 (ctypes.c_longlong * n)(*table.sizes),
                 (ctypes.c_longlong * n)(*table.row_starts), n, mu, wd,
                 int(bool(nesterov)), torch.cuda.current_stream().cuda_stream)
    if err:
        raise RuntimeError(f"momentum_update launch failed: CUDA error {err}")
    momentum_update.launches += 1
    if table is g:
        momentum_update.leaf_reads += n - table.copies
        momentum_update.leaf_copies += table.copies
    return x, m


momentum_update.launches = 0     # kernel launches since the last reset
momentum_update.leaf_reads = 0   # a table's leaves read where they lie
momentum_update.leaf_copies = 0  # a table's leaves copied before the launch
