"""δ-contraction compression operators (paper Definition 1).

Port of ``src/repro/core/compression.py:43-345``: the identity, the
blockwise scaled-sign, top-k and QSGD operators, rand-k and the sparse
rows of embedding-style workloads.  An
operator ``Q`` is a δ-contraction if ``‖x − Q(x)‖² ≤ (1 − δ)‖x‖²``;
CPD-SGDM (Alg. 2) sends ``q = Q(x_{t+1} − x̂_t)`` over the wire.

Every operator is paired with a :class:`~repro_torch.core.wire.WireCodec`
and ``apply`` is the codec round trip ``unpack ∘ pack``, so the simulated
math and the bytes on the wire agree by construction.  Operators are
blockwise, in blocks of :data:`SIGN_BLOCK` = ``LANE`` elements by default,
so the flatten-once kernel rows coincide with the per-leaf blocks.
"""
from __future__ import annotations

import dataclasses
from typing import Tuple

import numpy as np
import torch
import torch.nn.functional as F

from repro_torch.kernels import LANE as SIGN_BLOCK
from repro_torch.kernels.ref import (qsgd_bits, sign_pack_rows_ref,
                                     sign_unpack_ref, topk_width)

__all__ = [
    "Compressor", "IdentityCompressor", "SignCompressor", "TopKCompressor",
    "RandKCompressor", "QSGDCompressor", "SparseRowsCompressor",
    "make_compressor", "sign_pack", "sign_unpack", "sign_wire_bytes",
    "contraction_ratio", "SIGN_BLOCK",
]

def _pad_to(x: torch.Tensor, multiple: int) -> Tuple[torch.Tensor, int]:
    """Zero-pad a flat tensor to a multiple of ``multiple``; returns it and
    its true length."""
    n = x.shape[0]
    pad = (-n) % multiple
    if pad:
        x = F.pad(x, (0, pad))
    return x, n


def sign_pack(x: torch.Tensor, block: int = SIGN_BLOCK):
    """Blockwise scaled-sign compress + bit-pack of one leaf.

    Returns ``(packed (nblocks, block/8) u8, scales (nblocks,) f32)``:
    ``scale`` is the mean |x| over each block's true elements, summed in
    the fixed tree order of :func:`repro_torch.kernels.ref.tree_sum` (the
    order the kernel path uses, so the two paths agree bit for bit), and
    bit ``x ≥ 0``.  The true length ``n`` is ``x.numel()``; pass it to
    :func:`sign_unpack`.
    """
    from repro_torch.core.wire import _to_rows    # wire imports us
    rows, counts = _to_rows(x, block)
    packed, scales = sign_pack_rows_ref(rows, counts.reshape(-1, 1))
    return packed, scales.reshape(-1)


def sign_unpack(packed: torch.Tensor, scales: torch.Tensor, n: int, shape,
                dtype, block: int = SIGN_BLOCK) -> torch.Tensor:
    """Inverse of :func:`sign_pack`: Q(x) = scaleᵦ · sign(xᵦ).  ``block``
    is implied by the packed width; it is kept for the reference's
    signature."""
    vals = sign_unpack_ref(packed, scales.reshape(-1, 1))
    return vals.reshape(-1)[:n].reshape(shape).to(dtype)


def sign_wire_bytes(n: int, block: int = SIGN_BLOCK) -> int:
    """Exact packed-wire payload of an ``n``-element leaf: per block,
    ``block/8`` sign bytes and one f32 scale, the padded tail block
    included (it really ships)."""
    nblocks = -(-int(n) // block)
    return nblocks * (block // 8 + 4)


def contraction_ratio(x: torch.Tensor, qx: torch.Tensor) -> torch.Tensor:
    """‖x − Q(x)‖² / ‖x‖² — must be ≤ 1 − δ (Definition 1)."""
    x = x.to(torch.float32)
    num = torch.sum((x - qx.to(torch.float32)) ** 2)
    den = torch.clamp(torch.sum(x ** 2), min=1e-30)
    return num / den


@dataclasses.dataclass(frozen=True)
class Compressor:
    """Base δ-contraction operator.  ``apply(x)`` returns Q(x) with x's
    shape and dtype as the paired codec's ``unpack ∘ pack``;
    ``wire_bits_per_element`` is the per-element rate model and
    ``wire_bytes`` the exact payload of one leaf."""

    name: str = "identity"

    def _codec(self):
        from repro_torch.core.wire import make_codec   # wire imports us
        return make_codec(self)

    def apply(self, x: torch.Tensor, key=None) -> torch.Tensor:
        codec = self._codec()
        return codec.unpack(codec.pack(x, key), x.numel(), x.shape, x.dtype,
                            key=key)

    def wire_bits_per_element(self, dtype=torch.float32) -> float:
        raise NotImplementedError

    def delta_lower_bound(self, d: int) -> float:
        """A guaranteed δ for dimension d (may be loose)."""
        raise NotImplementedError

    def wire_bytes(self, x: torch.Tensor) -> int:
        """Exact shipped bytes for one leaf (the rate model for a
        compressor without a codec)."""
        try:
            codec = self._codec()
        except TypeError:
            return int(np.ceil(
                x.numel() * self.wire_bits_per_element(x.dtype) / 8.0))
        return codec.wire_bytes(x.numel())


@dataclasses.dataclass(frozen=True)
class IdentityCompressor(Compressor):
    name: str = "identity"

    def apply(self, x, key=None):
        return x

    def wire_bits_per_element(self, dtype=torch.float32):
        return float(dtype.itemsize * 8)

    def wire_bytes(self, x: torch.Tensor) -> int:
        # this tensor shipped uncompressed; CPD's codec ships the f32 drift
        return int(x.numel() * x.dtype.itemsize)

    def delta_lower_bound(self, d):
        return 1.0


@dataclasses.dataclass(frozen=True)
class SignCompressor(Compressor):
    """Blockwise scaled sign (the paper's experimental choice):
    Q(x)ᵦ = mean(|xᵦ|) · sign(xᵦ) per block; 1 bit per element and one f32
    scale per block on the wire."""

    name: str = "sign"
    block: int = SIGN_BLOCK

    def apply(self, x, key=None):
        packed, scales = sign_pack(x, self.block)
        return sign_unpack(packed, scales, x.numel(), x.shape, x.dtype,
                           self.block)

    def wire_bits_per_element(self, dtype=torch.float32):
        return 1.0 + 32.0 / self.block

    def delta_lower_bound(self, d):
        return 1.0 / min(d, self.block)


@dataclasses.dataclass(frozen=True)
class TopKCompressor(Compressor):
    """Keep the top ``fraction`` of entries by magnitude, blockwise: each
    block of ``block`` elements (the kernel rows) keeps its own
    ``ceil(fraction·d_b)`` largest entries; for a leaf of at most one block
    this is global top-k.  δ ≥ fraction.  Wire: (i32 idx, f32 val) per
    slot, ``TopKCodec``."""

    name: str = "topk"
    fraction: float = 0.01
    block: int = SIGN_BLOCK

    def _k(self, d: int) -> int:
        return max(1, int(np.ceil(self.fraction * d)))

    def wire_bits_per_element(self, dtype=torch.float32):
        # W slots of (idx, val) per block of `block` elements
        return topk_width(self.fraction, self.block) * 64.0 / self.block

    def delta_lower_bound(self, d):
        if d <= self.block:
            return self._k(d) / d
        return self.fraction       # min over blocks of ceil(f·d_b)/d_b ≥ f


@dataclasses.dataclass(frozen=True)
class RandKCompressor(Compressor):
    """Keep a random fraction of the coordinates (unscaled); E‖x − Q‖² =
    (1 − k/d)‖x‖².  The kept coordinates come from the round key alone,
    which sender and receiver share (it names the leaf and the round, never
    the worker), so only the k values ship (``RandKCodec``)."""

    name: str = "randk"
    fraction: float = 0.01

    def wire_bits_per_element(self, dtype=torch.float32):
        # indices reproducible from the shared key: only k f32 values ship
        return self.fraction * 32.0

    def delta_lower_bound(self, d):
        return max(1.0 / d, self.fraction)  # in expectation


@dataclasses.dataclass(frozen=True)
class QSGDCompressor(Compressor):
    """QSGD-style s-level quantization, max-norm scaled per block, with
    deterministic nearest rounding (so it is a contraction).  The
    2·levels+1 levels bit-pack into ``qsgd_bits(levels)`` ∈ {2, 4, 8}
    bits; the default ``levels=7`` is the 4-bit wire."""

    name: str = "qsgd"
    levels: int = 7
    block: int = SIGN_BLOCK

    def wire_bits_per_element(self, dtype=torch.float32):
        return qsgd_bits(self.levels) + 32.0 / self.block

    def delta_lower_bound(self, d):
        # the per-block max quantizes exactly (δ ≥ 1/d); nearest rounding
        # also bounds the per-block ratio by d_b/(4s²)
        d_eff = min(d, self.block)
        return max(1.0 / d, 1.0 - d_eff / (4.0 * self.levels ** 2))


@dataclasses.dataclass(frozen=True)
class SparseRowsCompressor(Compressor):
    """Ship only the ``max_rows`` largest rows (by L2 norm) of each leaf's
    blockwise layout: the push-by-key wire of embedding tables, where a
    round touches a few rows of a large table.

    A leaf is ``nb = ceil(d / block)`` rows of ``block`` elements (the
    kernel rows); the wire carries ``R = min(max_rows, nb)`` (i32 row
    index, row payload) pairs, the payload being the ``inner`` codec of the
    gathered rows: ``"f32"`` raw rows (lossless on the touched rows),
    ``"sign"`` or ``"qsgd"`` row-wise.  Untouched rows decode to exact 0.
    δ: the top-R rows keep at least R/nb of ‖x‖², times the inner
    operator's δ."""

    name: str = "sparse_rows"
    max_rows: int = 64
    inner: str = "f32"     # "f32" | "sign" | "qsgd"
    levels: int = 7        # inner="qsgd" quantization levels
    block: int = SIGN_BLOCK

    def _inner_row_bytes(self) -> int:
        """Exact wire bytes per shipped row (excluding the row index)."""
        if self.inner == "f32":
            return 4 * self.block
        if self.inner == "sign":
            return self.block // 8 + 4          # bits + f32 scale
        if self.inner == "qsgd":
            return self.block * qsgd_bits(self.levels) // 8 + 4
        raise ValueError(f"unknown sparse inner codec {self.inner!r}")

    def wire_bits_per_element(self, dtype=torch.float32):
        # per touched element: bytes scale with rows touched, not leaf size
        return 8.0 * (4 + self._inner_row_bytes()) / self.block

    def delta_lower_bound(self, d):
        nb = -(-int(d) // self.block)
        keep = min(self.max_rows, nb) / nb      # top-R rows keep ≥ R/nb energy
        if self.inner == "f32":
            return keep
        inner = (SignCompressor(block=self.block) if self.inner == "sign"
                 else QSGDCompressor(levels=self.levels, block=self.block))
        return keep * inner.delta_lower_bound(min(d, self.block))


def make_compressor(name: str, **kw) -> Compressor:
    name = name.lower()
    if name in ("identity", "none", "full"):
        return IdentityCompressor()
    if name == "sign":
        return SignCompressor(**kw)
    if name == "topk":
        return TopKCompressor(**kw)
    if name == "randk":
        return RandKCompressor(**kw)
    if name == "qsgd":
        return QSGDCompressor(**kw)
    if name in ("sparse", "sparse_rows"):
        return SparseRowsCompressor(**kw)
    if name.startswith("sparse+"):          # composed: sparse+sign, sparse+qsgd
        return SparseRowsCompressor(inner=name.split("+", 1)[1], **kw)
    raise ValueError(f"unknown compressor {name!r}")
