"""Wire codecs: the payload each compressor ships, and its pack/unpack.

Port of ``src/repro/core/wire.py``.  A :class:`WireCodec` is the wire
format of a δ-contraction operator: the dict of tensors that crosses the
interconnect, plus the maps between a parameter-drift tensor and it, so
``Q = unpack ∘ pack`` by construction and the byte accounting is read off
the payload shapes.

Payload layouts (per leaf of ``n`` elements, ``nb = ceil(n / block)``):

===========  =====================================================  ===================
codec        payload                                                bytes
===========  =====================================================  ===================
identity     ``vals``   f32 (n,)                                    4·n
sign         ``bits``   u8 (nb, block/8), ``scales`` f32 (nb,)      nb·(block/8 + 4)
topk         ``idx``    i32 (nb, W), ``vals`` f32 (nb, W)           nb·W·8
randk        ``vals``   f32 (k,); ``idx`` derived from the key      k·4
qsgd         ``levels`` u8 (nb, block·bits/8), ``norms`` f32 (nb,)  nb·(block·bits/8 + 4)
sparse_rows  ``rowidx`` i32 (R,) + the inner payload of the         R·(4 + row)
             gathered (R, block) rows (f32 / sign / qsgd rows)
===========  =====================================================  ===================

with ``W = max(1, ceil(fraction·block))``, ``R = min(max_rows, nb)`` and
``row`` the inner codec's bytes per row.

Two domains share one semantics: ``pack``/``unpack`` per leaf (any shape,
any block) and ``rows_pack``/``rows_unpack`` on the flatten-once
``(rows, LANE)`` layout through the CUDA kernels, available when
``rows_supported`` and ``block == LANE``.  The rows math has one definition,
the kernels' plain versions in :mod:`repro_torch.kernels.ref` (the sign
scale's fixed summation tree, the reference's ``_tree_sum``, is
``kernels.ref.tree_sum``), so the two domains agree bit for bit.

Rand-k's kept coordinates come from a :class:`WireKey`, the (leaf, round)
pair that every worker knows, so no index ships.  The reference draws them
with ``jax.random.choice``, which PyTorch cannot reproduce: the port draws
them from its own generator seeded from (17, leaf, round), the same
contract with other numbers.  The optimizer derives them once per leaf
per round (``RandKCodec.derive_idx``), outside ``vmap``, for every worker
alike.
"""
from __future__ import annotations

import dataclasses
from typing import Dict

import numpy as np
import torch

from repro_torch.core.compression import (Compressor, IdentityCompressor,
                                          QSGDCompressor, RandKCompressor,
                                          SIGN_BLOCK, SignCompressor,
                                          SparseRowsCompressor,
                                          TopKCompressor, _pad_to,
                                          sign_pack, sign_unpack,
                                          sign_wire_bytes)
from repro_torch.kernels import ops as kops
from repro_torch.kernels.ref import (_pack_fields, qsgd_bits, qsgd_rows_ref,
                                     qsgd_rows_unpack_ref, sign_unpack_ref,
                                     topk_rows_ref, topk_width, tree_sum)
# the inverse scatter of topk_rows → (R, block) f32: (0, 0.0) placeholder
# slots add nothing
from repro_torch.kernels.ref import topk_rows_unpack_ref as topk_rows_unpack
from repro_torch.tree import leaf_order

__all__ = [
    "WireCodec", "IdentityCodec", "SignCodec", "TopKCodec", "RandKCodec",
    "QSGDCodec", "SparseRowsCodec", "WireKey", "make_codec", "wire_key",
    "topk_rows", "topk_rows_unpack", "qsgd_rows", "qsgd_rows_unpack",
    "qsgd_bits", "sign_rows", "sign_rows_unpack", "sparse_row_select",
    "topk_width", "payload_nbytes", "leaf_keys", "pack_tree",
    "round_trip_tree", "unpack_tree",
]

Payload = Dict[str, torch.Tensor]


@dataclasses.dataclass(frozen=True)
class WireKey:
    """The key of one leaf's payload in one communication round: the leaf
    index (in the reference's leaf order) and the round, never the worker,
    so every worker derives the same rand-k coordinates."""
    leaf: int
    round: int


def wire_key(r, leaf_i: int) -> WireKey:
    """Key of leaf ``leaf_i``'s payload in round ``r``.  ``r`` may be a
    0-d tensor on the card; reading it syncs the host, so only a keyed
    codec (rand-k) asks for a key."""
    return WireKey(int(leaf_i), int(r))


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


def topk_rows(x: torch.Tensor, counts=None, *, fraction: float,
              width=None):
    """Blockwise magnitude top-k on (R, B) rows → ``(idx (R, W) i32, vals
    (R, W) f32)``; ``counts`` (R,) or (R, 1) valid elements per row (None:
    full rows).  The plain version of the top-k select kernel."""
    if counts is not None:
        counts = counts.reshape(-1, 1).to(torch.float32)
    return topk_rows_ref(x.to(torch.float32), counts, fraction=fraction,
                         width=width)


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


def sign_rows(x: torch.Tensor, counts=None):
    """Blockwise scaled sign on (R, B) rows, the sparse wire's inner sign
    codec → ``(packed (R, B/8) u8, scales (R,) f32)``: ``scale =
    tree_sum(|x|) · (1 / max(count, 1))``, the divisor as a reciprocal and
    one product, as the reference spells it (``wire.py:264``).  The
    reciprocal is a tensor divided by a tensor: PyTorch computes ``scalar /
    tensor`` as ``reciprocal(tensor) · scalar``."""
    rows, block = x.shape
    x = x.to(torch.float32)
    if counts is None:
        counts = torch.full((rows,), float(block), device=x.device)
    c = torch.clamp(counts.reshape(rows).to(torch.float32), min=1.0)
    scales = tree_sum(x.abs()) * (torch.ones_like(c) / c)
    return _pack_fields((x >= 0).to(torch.uint8), 1), scales


def sign_rows_unpack(packed: torch.Tensor, scales: torch.Tensor, *,
                     block: int) -> torch.Tensor:
    """Inverse of :func:`sign_rows` → (R, block) f32 ``scale·sign``; a zero
    row decodes to ±0 (adding it is the identity)."""
    return sign_unpack_ref(packed, scales.reshape(-1, 1)).reshape(-1, block)


def _top_rows(norms: torch.Tensor, budget: int) -> torch.Tensor:
    """Indices of the ``budget`` largest ``norms`` along the last axis,
    ties to the lowest index (``lax.top_k``'s order), sorted ascending,
    i32.  ``torch.topk`` promises no tie order, so a stable sort does it:
    the tie decides which untouched rows an under-full budget ships."""
    order = torch.sort(norms, dim=-1, descending=True, stable=True)[1]
    return torch.sort(order[..., :budget], dim=-1)[0].to(torch.int32)


def sparse_row_select(x: torch.Tensor, budget: int) -> torch.Tensor:
    """The touched-row selector of the sparse wire: indices of the
    ``budget`` rows of (R, B) ``x`` with the largest squared L2 norm,
    summed in the fixed :func:`~repro_torch.kernels.ref.tree_sum` order,
    sorted ascending (i32).  Untouched (zero) rows are taken, lowest index
    first, only when fewer than ``budget`` rows are touched; they ship
    zeros and decode to exact 0."""
    return _top_rows(tree_sum(torch.square(x.to(torch.float32))), budget)


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

    # whether pack/unpack read the round key (rand-k); no other codec does,
    # so the caller builds a key only for a keyed codec
    keyed = False

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
class TopKCodec(WireCodec):
    """Blockwise top-k: W = ceil(fraction·block) (idx, val) slots per
    block; the active slots follow each block's true length."""

    name: str = "topk"
    fraction: float = 0.01
    block: int = SIGN_BLOCK

    @property
    def width(self) -> int:
        return topk_width(self.fraction, self.block)

    @property
    def rows_supported(self):
        # the select kernel's cap decides kernel wire or per-leaf codec, as
        # the reference's unroll cap does
        from repro_torch.kernels.topk_select import MAX_WIDTH
        return self.width <= MAX_WIDTH

    def pack(self, x, key=None):
        rows, counts = _to_rows(x, self.block)
        idx, vals = topk_rows(rows, counts, fraction=self.fraction,
                              width=self.width)
        return {"idx": idx, "vals": vals}

    def unpack(self, payload, n, shape, dtype, key=None):
        q = topk_rows_unpack(payload["idx"], payload["vals"], self.block)
        return q.reshape(-1)[:n].reshape(shape).to(dtype)

    def rows_pack(self, mat, counts=None, *, plan=None):
        idx, vals = kops.topk_pack(mat, counts, fraction=self.fraction)
        return {"idx": idx, "vals": vals}

    def rows_unpack(self, payload, *, plan=None):
        return kops.topk_unpack(payload["idx"], payload["vals"])

    def wire_bytes(self, n):
        nb = -(-int(n) // self.block)
        return nb * self.width * (4 + 4)     # i32 idx + f32 val per slot


@dataclasses.dataclass(frozen=True)
class RandKCodec(WireCodec):
    """Random-k with key-derived coordinates: sender and receiver derive
    the same k indices from the shared :class:`WireKey`, so only the k
    values ship.  ``pack``/``unpack`` take the key, or the indices
    :meth:`derive_idx` derived from it (drawing inside ``vmap`` is not
    allowed, so the optimizer derives them before)."""

    name: str = "randk"
    fraction: float = 0.01
    keyed = True

    def k(self, n: int) -> int:
        return max(1, int(np.ceil(self.fraction * int(n))))

    def derive_idx(self, key, n: int, device=None) -> torch.Tensor:
        """k distinct coordinates of an n-element leaf, a function of the
        key alone (drawn on the host, so every device gets the same; key
        None: a fixed stream, as the reference's ``PRNGKey(0)``)."""
        ids = [17] if key is None else [17, key.leaf, key.round]
        seed = int(np.random.SeedSequence(ids).generate_state(
            1, np.uint64)[0])
        gen = torch.Generator().manual_seed(seed)
        return torch.randperm(int(n), generator=gen)[:self.k(n)].to(device)

    def _idx(self, key, n, device):
        if isinstance(key, torch.Tensor):
            return key
        return self.derive_idx(key, n, device)

    def pack(self, x, key=None):
        flat = x.reshape(-1).to(torch.float32)
        idx = self._idx(key, flat.shape[0], flat.device)
        return {"idx": idx, "vals": flat[idx]}

    def unpack(self, payload, n, shape, dtype, key=None):
        vals = payload["vals"]
        idx = payload.get("idx")
        if idx is None:                      # wire payload: re-derive
            idx = self._idx(key, n, vals.device)
        flat = torch.zeros((n,), dtype=torch.float32,
                           device=vals.device).scatter(0, idx, vals)
        return flat.reshape(shape).to(dtype)

    def wire(self, payload):
        return {"vals": payload["vals"]}

    def wire_bytes(self, n):
        return self.k(n) * 4


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


@dataclasses.dataclass(frozen=True)
class SparseRowsCodec(WireCodec):
    """Touched-rows wire: (row index, row values) pairs, the push-by-key
    wire of embedding tables.

    A leaf is its blockwise ``(nb, block)`` rows (the kernel rows when
    ``block == LANE``); the payload ships the ``R = min(max_rows, nb)``
    rows of largest squared L2 norm as an i32 ``rowidx`` plus the ``inner``
    codec's payload of the gathered ``(R, block)`` rows (``"f32"`` raw
    rows, ``"sign"``, ``"qsgd"``).  Untouched rows decode to exact 0.

    Rows domain: the selection and the inner codec are plain PyTorch on
    the compact gathered rows in both domains, as in the reference; the
    CUDA row gather and scatter only move rows, so the two domains agree
    bit for bit.  Both rows entry points need the ``KernelPlan``: the
    per-leaf budgets come from its slots.  ``rows_wire`` is the identity:
    the payload is already compact.
    """

    name: str = "sparse_rows"
    max_rows: int = 64
    inner: str = "f32"     # "f32" | "sign" | "qsgd"
    levels: int = 7        # inner="qsgd" quantization levels
    block: int = SIGN_BLOCK

    @property
    def rows_supported(self):
        return True

    def budget(self, n: int) -> int:
        """Shipped rows of an n-element leaf."""
        return min(self.max_rows, -(-int(n) // self.block))

    def plan_budget(self, plan) -> int:
        """Shipped rows S of a kernel plan: the per-leaf budgets summed."""
        return sum(min(self.max_rows, s.n_rows) for s in plan.slots)

    def plan_select(self, mat, plan) -> torch.Tensor:
        """Touched-row indices on the flatten-once layout, (..., S) i32:
        each leaf's top-budget rows (squared L2 norm, ties to the lowest
        row, sorted ascending) offset by the leaf's ``row_start``.  Leaf
        segments are disjoint and ordered, so the indices are distinct and
        sorted, the scatter kernel's contract."""
        norms = tree_sum(torch.square(mat.to(torch.float32)))
        parts = []
        for s in plan.slots:
            seg = norms[..., s.row_start:s.row_start + s.n_rows]
            parts.append(_top_rows(seg, min(self.max_rows, s.n_rows))
                         + s.row_start)
        return torch.cat(parts, dim=-1)

    # -- inner (value) codec on the gathered (..., R, block) rows ----------
    def _inner_pack(self, g, gcnt) -> Payload:
        lead, s = g.shape[:-2], g.shape[-2]
        if self.inner == "f32":
            return {"rows": g.to(torch.float32)}
        g2 = g.reshape(-1, self.block)
        if self.inner == "sign":
            bits, scales = sign_rows(g2, gcnt.reshape(-1))
            return {"bits": bits.reshape(lead + (s, self.block // 8)),
                    "scales": scales.reshape(lead + (s,))}
        if self.inner == "qsgd":
            packed, norms = qsgd_rows(g2, levels=self.levels)
            return {"levels": packed.reshape(lead + (s, packed.shape[-1])),
                    "norms": norms.reshape(lead + (s,))}
        raise ValueError(f"unknown sparse inner codec {self.inner!r}")

    def _inner_unpack(self, payload: Payload) -> torch.Tensor:
        if self.inner == "f32":
            return payload["rows"].to(torch.float32)
        if self.inner == "sign":
            bits = payload["bits"]
            lead, s = bits.shape[:-2], bits.shape[-2]
            g = sign_rows_unpack(bits.reshape(-1, self.block // 8),
                                 payload["scales"].reshape(-1),
                                 block=self.block)
            return g.reshape(lead + (s, self.block))
        if self.inner == "qsgd":
            lv = payload["levels"]
            lead, s = lv.shape[:-2], lv.shape[-2]
            g = qsgd_rows_unpack(lv.reshape(-1, lv.shape[-1]),
                                 payload["norms"].reshape(-1),
                                 levels=self.levels, block=self.block)
            return g.reshape(lead + (s, self.block))
        raise ValueError(f"unknown sparse inner codec {self.inner!r}")

    def _row_payload_bytes(self) -> int:
        """Wire bytes per shipped row, excluding the i32 index."""
        if self.inner == "f32":
            return 4 * self.block
        if self.inner == "sign":
            return self.block // 8 + 4
        if self.inner == "qsgd":
            return self.block * qsgd_bits(self.levels) // 8 + 4
        raise ValueError(f"unknown sparse inner codec {self.inner!r}")

    # -- per-leaf domain ---------------------------------------------------
    def pack(self, x, key=None):
        rows, counts = _to_rows(x, self.block)
        idx = sparse_row_select(rows, self.budget(x.numel()))
        g = rows[idx.long()]
        gcnt = counts[idx.long()]
        return {"rowidx": idx, **self._inner_pack(g, gcnt)}

    def unpack(self, payload, n, shape, dtype, key=None):
        nb = -(-int(n) // self.block)
        g = self._inner_unpack(payload)
        q = torch.zeros((nb, self.block), dtype=torch.float32,
                        device=g.device).index_add(
                            0, payload["rowidx"].long(), g)
        return q.reshape(-1)[:n].reshape(shape).to(dtype)

    # -- (rows, LANE) kernel domain ------------------------------------------
    def rows_pack(self, mat, counts=None, *, plan=None):
        """``counts``: the plan's row counts per worker or tiled over the
        workers (the optimizer passes them tiled); each gathered row's
        count is read at its own worker's source row."""
        if plan is None:
            raise ValueError("sparse_rows rows_pack needs the KernelPlan: "
                             "per-leaf row segments set the index budgets")
        if counts is None:
            counts = plan.row_counts(mat.device)
        lead, rows = mat.shape[:-2], mat.shape[-2]
        idx = self.plan_select(mat, plan)
        g = kops.row_gather(mat, idx, counts)
        tiled = kops.tile_counts(counts, rows, lead).reshape(-1, rows)
        gcnt = torch.gather(tiled, 1, idx.reshape(tiled.shape[0], -1).long())
        return {"rowidx": idx,
                **self._inner_pack(g, gcnt.reshape(idx.shape))}

    def rows_unpack(self, payload, *, plan=None):
        if plan is None:
            raise ValueError("sparse_rows rows_unpack needs the KernelPlan: "
                             "the scatter extent is the plan's row count")
        return kops.row_scatter(payload["rowidx"],
                                self._inner_unpack(payload), rows=plan.rows)

    def rows_wire(self, payload, plan):
        return dict(payload)         # already compact: every entry ships

    def rows_unwire(self, wire, plan):
        return dict(wire)

    # -- accounting ----------------------------------------------------------
    def wire_bytes(self, n):
        return self.budget(n) * (4 + self._row_payload_bytes())


def make_codec(comp: Compressor) -> WireCodec:
    """The wire codec paired with a compressor instance."""
    if isinstance(comp, SignCompressor):
        return SignCodec(block=comp.block)
    if isinstance(comp, TopKCompressor):
        return TopKCodec(fraction=comp.fraction, block=comp.block)
    if isinstance(comp, RandKCompressor):
        return RandKCodec(fraction=comp.fraction)
    if isinstance(comp, QSGDCompressor):
        return QSGDCodec(levels=comp.levels, block=comp.block)
    if isinstance(comp, SparseRowsCompressor):
        return SparseRowsCodec(max_rows=comp.max_rows, inner=comp.inner,
                               levels=comp.levels, block=comp.block)
    if isinstance(comp, IdentityCompressor):
        return IdentityCodec()
    raise TypeError(f"no wire codec for compressor {comp!r}")


def leaf_keys(codec: WireCodec, tree: dict, r) -> dict:
    """Per leaf of a worker-stacked ``tree``, what a keyed codec's pack and
    unpack take: the indices of the shared (leaf, round) key, derived once,
    outside ``vmap``, for every worker alike.  None for the other codecs,
    which read no key (building one would read the round off the
    device)."""
    if not codec.keyed:
        return {name: None for name in tree}
    keys = {}
    for i, name in enumerate(leaf_order(tree)):
        leaf = tree[name]
        n = int(np.prod(tuple(leaf.shape[1:]), dtype=np.int64))
        keys[name] = codec.derive_idx(wire_key(r, i), n, leaf.device)
    return keys


def pack_tree(codec: WireCodec, tree: dict, keys: dict) -> dict:
    """The per-leaf payload of every leaf of a worker-stacked ``tree``,
    per worker (``torch.func.vmap``); ``keys`` from :func:`leaf_keys`."""
    return {name: torch.func.vmap(lambda x, key=keys[name]:
                                  codec.pack(x, key))(leaf)
            for name, leaf in tree.items()}


def unpack_tree(codec: WireCodec, payloads: dict, like: dict,
                keys: dict) -> dict:
    """The f32 decode of per-leaf ``payloads`` (worker-stacked, as
    :func:`pack_tree` makes them, or received) to the leaves of ``like``."""
    out = {}
    for name, leaf in like.items():
        shape = tuple(leaf.shape[1:])
        n = int(np.prod(shape, dtype=np.int64)) if shape else 1
        out[name] = torch.func.vmap(
            lambda p, key=keys[name]: codec.unpack(
                p, n, shape, torch.float32, key=key))(payloads[name])
    return out


def round_trip_tree(codec: WireCodec, tree: dict, r) -> dict:
    """``unpack(pack(x))`` of every leaf of a worker-stacked ``tree``, per
    worker (``torch.func.vmap``), with round ``r``'s shared keys: what each
    worker decodes from the per-leaf payload of round ``r``."""
    keys = leaf_keys(codec, tree, r)
    return unpack_tree(codec, pack_tree(codec, tree, keys), tree, keys)


def payload_nbytes(payload: Payload) -> int:
    """Σ bytes over a payload dict: the shipped side of accounted ≡
    shipped."""
    return sum(int(t.numel()) * t.element_size() for t in payload.values())
