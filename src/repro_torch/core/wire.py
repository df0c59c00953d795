"""Wire codecs: the payload each compressor ships, and its pack/unpack.

Port of ``src/repro/core/wire.py:99-116``, ``159-284``, ``302-412``,
``498-538`` and ``693-715`` for the identity, sign and QSGD codecs.  A
:class:`WireCodec` is the wire format of a δ-contraction operator: the
dict of tensors that crosses the interconnect, plus the maps between a
parameter-drift tensor and it, so ``Q = unpack ∘ pack`` by construction
and the byte accounting is read off the payload shapes.

Payload layouts (per leaf of ``n`` elements, ``nb = ceil(n / block)``):

========  =====================================================  ===================
codec     payload                                                bytes
========  =====================================================  ===================
identity  ``vals``   f32 (n,)                                    4·n
sign      ``bits``   u8 (nb, block/8), ``scales`` f32 (nb,)      nb·(block/8 + 4)
qsgd      ``levels`` u8 (nb, block·bits/8), ``norms`` f32 (nb,)  nb·(block·bits/8 + 4)
========  =====================================================  ===================

Two domains share one semantics: ``pack``/``unpack`` per leaf (any shape,
any block) and ``rows_pack``/``rows_unpack`` on the flatten-once
``(rows, LANE)`` layout through the CUDA kernels, available when
``rows_supported`` and ``block == LANE``.  The rows math has one definition,
the kernels' plain versions in :mod:`repro_torch.kernels.ref` (the sign
scale's fixed summation tree, the reference's ``_tree_sum``, is
``kernels.ref.tree_sum``), so the two domains agree bit for bit.

Not ported: the top-k, rand-k and sparse-rows codecs and ``wire_key``,
whose JAX key only serves rand-k (ROADMAP queue A item 6).  The codecs
here take a ``key`` argument for the reference's signature and ignore it.
"""
from __future__ import annotations

import dataclasses
from typing import Dict

import torch

from repro_torch.core.compression import (Compressor, IdentityCompressor,
                                          QSGDCompressor, SIGN_BLOCK,
                                          SignCompressor, _pad_to, sign_pack,
                                          sign_unpack, sign_wire_bytes)
from repro_torch.kernels import ops as kops
from repro_torch.kernels.ref import (qsgd_bits, qsgd_rows_ref,
                                     qsgd_rows_unpack_ref)

__all__ = [
    "WireCodec", "IdentityCodec", "SignCodec", "QSGDCodec", "make_codec",
    "qsgd_rows", "qsgd_rows_unpack", "qsgd_bits", "payload_nbytes",
]

Payload = Dict[str, torch.Tensor]

_NOT_YET = ("the top-k, rand-k and sparse-rows codecs are ROADMAP queue A "
            "item 6")


def _row_counts(n: int, block: int, device=None) -> torch.Tensor:
    """(nb,) f32 valid-element count per padded row of one n-element leaf:
    ``KernelPlan.row_counts`` restricted to that leaf."""
    nb = -(-n // block)
    c = torch.full((nb,), float(block), dtype=torch.float32, device=device)
    c[-1] = float(n - (nb - 1) * block)
    return c


def _to_rows(x: torch.Tensor, block: int):
    """Leaf → zero-padded f32 (nb, block) rows + valid counts."""
    flat, n = _pad_to(x.reshape(-1).to(torch.float32), block)
    return flat.reshape(-1, block), _row_counts(n, block, flat.device)


def qsgd_rows(x: torch.Tensor, *, levels: int):
    """Blockwise QSGD quantize + bit-pack on (R, B) rows → ``(packed
    (R, B·bits/8) u8, norms (R,) f32)``; the plain version of the QSGD
    kernel with the reference's (R,) norms."""
    packed, norms = qsgd_rows_ref(x.to(torch.float32), levels)
    return packed, norms.reshape(-1)


def qsgd_rows_unpack(packed: torch.Tensor, norms: torch.Tensor, *,
                     levels: int, block: int) -> torch.Tensor:
    """Inverse of :func:`qsgd_rows` → (R, block) f32."""
    return qsgd_rows_unpack_ref(packed, norms.reshape(-1, 1),
                                levels).reshape(-1, block)


# ------------------------------------------------------------------- codecs
@dataclasses.dataclass(frozen=True)
class WireCodec:
    """Wire format of one compressor: payload layout + pack/unpack maps.

    ``pack``/``unpack`` are the per-leaf domain (any shape;
    ``torch.func.vmap`` maps them over a stacked worker dim);
    ``rows_pack``/``rows_unpack`` the ``(rows, LANE)`` kernel domain,
    available iff :attr:`rows_supported`.  ``wire(payload)`` is what ships;
    ``wire_bytes(n)`` its exact size.
    """

    name: str = "codec"
    block: int = 0

    @property
    def rows_supported(self) -> bool:
        """Whether the (rows, LANE) kernel path exists for this codec (the
        caller also requires ``block == LANE``)."""
        return False

    # -- per-leaf domain ---------------------------------------------------
    def pack(self, x: torch.Tensor, key=None) -> Payload:
        raise NotImplementedError

    def unpack(self, payload: Payload, n: int, shape, dtype,
               key=None) -> torch.Tensor:
        raise NotImplementedError

    # -- (rows, LANE) kernel domain ------------------------------------------
    def rows_pack(self, mat, counts=None, *, plan=None) -> Payload:
        raise NotImplementedError(f"{self.name}: no kernel wire format")

    def rows_unpack(self, payload: Payload, *, plan=None):
        raise NotImplementedError(f"{self.name}: no kernel wire format")

    def rows_wire(self, payload: Payload, plan) -> Payload:
        """Trim a rows-domain payload to its wire extent before a neighbour
        exchange: every array sliced to ``plan.used_rows``, so alignment
        padding never ships."""
        u = plan.used_rows
        return {k: v[..., :u, :] for k, v in payload.items()}

    def rows_unwire(self, wire: Payload, plan) -> Payload:
        """Receiver-side inverse of :meth:`rows_wire`: each array re-padded
        with zero rows to the kernel row extent."""
        return {k: plan.pad_wire(v) for k, v in wire.items()}

    # -- accounting ----------------------------------------------------------
    def wire(self, payload: Payload) -> Payload:
        """The payload entries that cross the wire."""
        return payload

    def wire_bytes(self, n: int) -> int:
        """Exact shipped bytes for an n-element leaf: Σ nbytes of the
        :meth:`wire` arrays, padding blocks included."""
        raise NotImplementedError


@dataclasses.dataclass(frozen=True)
class IdentityCodec(WireCodec):
    """Uncompressed wire.  CPD-SGDM's q is the f32 drift x − x̂, so the
    payload is f32 whatever the parameter dtype."""

    name: str = "identity"

    def pack(self, x, key=None):
        return {"vals": x.reshape(-1).to(torch.float32)}

    def unpack(self, payload, n, shape, dtype, key=None):
        return payload["vals"].reshape(shape).to(dtype)

    def wire_bytes(self, n):
        return 4 * int(n)


@dataclasses.dataclass(frozen=True)
class SignCodec(WireCodec):
    """Blockwise scaled sign: 1 bit per element + one f32 scale per
    block."""

    name: str = "sign"
    block: int = SIGN_BLOCK

    @property
    def rows_supported(self):
        return True

    def pack(self, x, key=None):
        bits, scales = sign_pack(x, self.block)
        return {"bits": bits, "scales": scales}

    def unpack(self, payload, n, shape, dtype, key=None):
        return sign_unpack(payload["bits"], payload["scales"], n, shape,
                           dtype, self.block)

    def rows_pack(self, mat, counts=None, *, plan=None):
        if counts is None:
            raise ValueError("sign rows_pack needs the per-row valid counts "
                             "(KernelPlan.row_counts): they divide the scale")
        bits, scales = kops.sign_pack(mat, counts)
        return {"bits": bits, "scales": scales}

    def rows_unpack(self, payload, *, plan=None):
        return kops.sign_unpack(payload["bits"], payload["scales"])

    def wire_bytes(self, n):
        return sign_wire_bytes(n, self.block)


@dataclasses.dataclass(frozen=True)
class QSGDCodec(WireCodec):
    """Blockwise s-level quantization: bit-packed uintN levels + one f32
    norm per block (deterministic nearest rounding)."""

    name: str = "qsgd"
    levels: int = 7
    block: int = SIGN_BLOCK

    @property
    def bits(self) -> int:
        return qsgd_bits(self.levels)

    @property
    def rows_supported(self):
        return True

    def pack(self, x, key=None):
        rows, _ = _to_rows(x, self.block)
        packed, norms = qsgd_rows(rows, levels=self.levels)
        return {"levels": packed, "norms": norms}

    def unpack(self, payload, n, shape, dtype, key=None):
        q = qsgd_rows_unpack(payload["levels"], payload["norms"],
                             levels=self.levels, block=self.block)
        return q.reshape(-1)[:n].reshape(shape).to(dtype)

    def rows_pack(self, mat, counts=None, *, plan=None):
        packed, norms = kops.qsgd_pack(mat, levels=self.levels)
        return {"levels": packed, "norms": norms}

    def rows_unpack(self, payload, *, plan=None):
        return kops.qsgd_unpack(payload["levels"], payload["norms"],
                                levels=self.levels)

    def wire_bytes(self, n):
        nb = -(-int(n) // self.block)
        return nb * (self.block * self.bits // 8 + 4)


def make_codec(comp: Compressor) -> WireCodec:
    """The wire codec paired with a compressor instance."""
    if isinstance(comp, SignCompressor):
        return SignCodec(block=comp.block)
    if isinstance(comp, QSGDCompressor):
        return QSGDCodec(levels=comp.levels, block=comp.block)
    if isinstance(comp, IdentityCompressor):
        return IdentityCodec()
    if getattr(comp, "name", None) in ("topk", "randk", "sparse_rows"):
        raise NotImplementedError(f"{comp.name}: not ported yet — {_NOT_YET}")
    raise TypeError(f"no wire codec for compressor {comp!r}")


def payload_nbytes(payload: Payload) -> int:
    """Σ bytes over a payload dict: the shipped side of accounted ≡
    shipped."""
    return sum(int(t.numel()) * t.element_size() for t in payload.values())
