"""The shard plan: which dim of each param leaf splits over the model
(TP) axis and which over the data (FSDP) axis inside a worker.

Port of ``param_pspec`` and ``_fit`` (``src/repro/launch/sharding.py:
87-147``).  The reference hands its specs to GSPMD, which inserts the
collectives; the port runs Megatron-style manual TP and a per-leaf FSDP
gather (:mod:`repro_torch.models.layers`), so a leaf splits over the model
axis only where the module it belongs to can run on the split:

* column-parallel (the last dim): ``wq``, ``wk``, ``wv`` and their biases,
  ``wi``, ``wg`` (dense MLP and the MoE experts' f), MLA's ``wuq``,
  ``wuk``, ``wuv`` (their columns are head-major, so a contiguous split is
  a split by heads);
* row-parallel (the dim before it): ``attn.wo`` (GQA and MLA),
  ``mlp.wo``, the experts' ``wo`` (E, f, d), the SSD's ``out_proj``;
* over the vocab: ``embed.table`` (its rows) and ``lm_head.w`` (its
  columns);
* by **component** (:class:`Split` with ``segments``): the SSD's
  ``in_proj`` concatenates z, x (``d_inner`` each), B and C
  (``n_groups·d_state`` each) and dt (``n_heads``) along its columns, and
  ``conv_w``/``conv_b`` concatenate x, B and C along their channels; z's,
  x's and dt's segments split by heads, B and C stay whole on every rank.
  ``A_log``, ``dt_bias``, ``D`` and the gated norm's ``scale`` split by
  heads;
* replicated: the router, the norms, MLA's ``wdq``, ``wdkv``, ``wkr``,
  ``q_norm`` and ``kv_norm`` (every head reads the latents whole; the
  reference's contiguous split of ``wdq``/``wdkv`` over the model axis is
  dropped, which changes no value), every other leaf.

A dim that does not divide stays replicated, as ``_fit`` does, with the
unit the module splits by: attention's four leaves split together when the
KV heads divide (a query head group never straddles two ranks), MLA's when
its heads do, the SSD's when its heads do, the MLP's when ``d_ff`` does,
the vocab leaves when the vocab does, the experts' when their f does.

Over the FSDP axis (profile B) a leaf splits, after its TP shard, on the
dim ``param_pspec`` gives ``fsdp``: ``last2(fsdp, tp)`` for the
column-parallel leaves and ``lm_head``, ``last2(tp, fsdp)`` for the
row-parallel ones and the embedding, the experts' E dim for the MoE (d
where E does not divide), ``d`` of ``wkr``; where ``_fit`` drops the axis
(the dim does not divide, or the leaf is a bias, a norm, ``conv_w``, the
router or an SSM scalar) the leaf stays whole on every data rank.  The TP
and FSDP dims of a leaf are never the same dim.  ``fsdp_min_size``
(``ParallelCfg``) is read nowhere in the reference, so the port reads it
nowhere either.

The reference's ``make_shd`` hints (``src/repro/launch/runtime.py:62-109``:
``attn_ctx_shard``, ``moe_token_shard``) are GSPMD sharding constraints
and change no value; the port accepts the flags and does nothing with
them.

Split dims are negative, so a plan applies alike to one worker's leaf, to
a leaf with the worker dim of 1 and to a K-stacked one.

The serving cache (``cache_spec_tree``, ``src/repro/launch/sharding.py:
211-257``; :class:`CachePlan`): the cache's batch dim splits over the
layout's batch axes (``"pod"``, ``"data"``) where they divide the batch,
and a rank holds the cache of its heads: GQA's K and V by KV heads where
the attention splits, the SSD's state by heads and its conv window by the
in_proj's component split (x channels split, B and C whole); MLA's
latents and every ``pos`` stay whole.  Where the batch does not divide,
the reference splits the cache's slots (or the SSM state's ``d_state``)
over ``"data"``, a GSPMD layout that changes no value; the port instead
gives every rank of the group the whole batch and every slot (ROADMAP
"Later work": the memory that costs).
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional, Tuple

import torch

__all__ = ["CachePlan", "ShardPlan", "Split", "cache_spec_tree", "fsdp_split",
           "param_split", "shard_plan"]

@dataclasses.dataclass(frozen=True)
class Split:
    """A split of one dim: contiguous (``segments`` None), or segment by
    segment, ``segments`` the ``(length, split?)`` pairs along the dim;
    a split segment is cut contiguously, a whole one kept on every
    rank."""
    dim: int
    segments: Optional[Tuple[Tuple[int, bool], ...]] = None

    def length(self, n: int, size: int) -> int:
        if self.segments is None:
            return n // size
        return sum(ln // size if cut else ln for ln, cut in self.segments)

    def cut(self, t: torch.Tensor, size: int, i: int) -> torch.Tensor:
        d = self.dim
        if self.segments is None:
            n = t.shape[d] // size
            return t.narrow(d, i * n, n)
        out, at = [], 0
        for ln, cut in self.segments:
            seg = t.narrow(d, at, ln)
            out.append(seg.narrow(d, i * (ln // size), ln // size) if cut
                       else seg)
            at += ln
        return torch.cat(out, dim=d)

    def join(self, parts) -> torch.Tensor:
        d, size = self.dim, len(parts)
        if self.segments is None:
            return torch.cat(list(parts), dim=d)
        out, at = [], 0
        for ln, cut in self.segments:
            n = ln // size if cut else ln
            if cut:
                out.extend(p.narrow(d, at, n) for p in parts)
            else:
                out.append(parts[0].narrow(d, at, n))
            at += n
        return torch.cat(out, dim=d)


def _ssd_split(leaf: str, owner: str, cfg, size: int) -> Optional[Split]:
    """The SSD leaves' split by heads (None where the heads do not
    divide, or the leaf stays whole)."""
    d_inner = cfg.ssm_expand * cfg.d_model
    heads = d_inner // cfg.ssm_headdim
    if heads % size:
        return None
    gn = cfg.ssm_state                        # one group (Mamba2Cfg's)
    if owner == "in_proj" and leaf == "w":
        return Split(-1, ((d_inner, True), (d_inner, True), (gn, False),
                          (gn, False), (heads, True)))
    if leaf in ("conv_w", "conv_b"):
        return Split(-1, ((d_inner, True), (2 * gn, False)))
    if owner == "out_proj" and leaf == "w":
        return Split(-2)
    if leaf in ("A_log", "dt_bias", "D") or (owner == "norm"
                                             and leaf == "scale"):
        return Split(-1)
    return None


def param_split(name: str, cfg, size: int) -> Optional[Split]:
    """The split of leaf ``name`` (the port's dotted key) of a model of
    config ``cfg`` over a model axis of ``size``, or None (replicated)."""
    if size == 1:
        return None
    parts = name.split(".")
    leaf, owner = parts[-1], parts[-2] if len(parts) > 1 else ""
    if name == "embed.table":
        return Split(-2) if cfg.vocab % size == 0 else None
    if name == "lm_head.w":
        return Split(-1) if cfg.vocab % size == 0 else None
    if ".moe." in name:
        if owner == "router" or cfg.d_ff % size:
            return None
        return {"wi": Split(-1), "wg": Split(-1), "wo": Split(-2)}.get(leaf)
    if ".mamba." in name:
        return _ssd_split(leaf, owner, cfg, size)
    if ".attn." in name and cfg.use_mla:
        if cfg.n_heads % size or owner not in ("wuq", "wuk", "wuv", "wo"):
            return None
        return Split(-2) if owner == "wo" else Split(-1)
    if ".attn." in name and owner in ("wq", "wk", "wv", "wo"):
        if cfg.n_kv_heads % size:
            return None
        return Split(-2) if owner == "wo" else Split(-1)
    if ".mlp." in name:
        if cfg.d_ff % size:
            return None
        return Split(-2) if owner == "wo" else Split(-1)
    return None


def fsdp_split(name: str, shape, size: int) -> Optional[int]:
    """The dim of leaf ``name`` (``shape`` its whole per-worker shape)
    that splits over an FSDP axis of ``size`` (``param_pspec``'s ``fsdp``
    placement and ``_fit``), or None (whole on every data rank)."""
    if size == 1:
        return None
    parts = name.split(".")
    leaf, owner = parts[-1], parts[-2] if len(parts) > 1 else ""
    base = len(shape) - (1 if name.startswith("blocks.") else 0)

    def fit(dim):
        return dim if -dim <= base and shape[dim] % size == 0 else None

    if name == "embed.table":
        return fit(-1)
    if name == "lm_head.w":
        return fit(-2)
    if ".moe." in name and leaf in ("wi", "wg", "wo"):
        e = fit(-3)
        if e is not None:
            return e
        return fit(-2 if leaf != "wo" else -1)
    if owner == "router" or leaf != "w" or base < 2:
        return None
    if owner in ("wo", "out_proj"):
        return fit(-1)
    return fit(-2)              # column-parallel, and wkr's d


@dataclasses.dataclass(frozen=True)
class ShardPlan:
    """Every leaf's TP split (``splits``) over a model axis of ``size``,
    this rank at ``index`` on it, and its FSDP dim (``fsdp``) over a data
    axis of ``fsdp_size``, this rank at ``fsdp_index``; ``shapes`` are the
    whole per-worker shapes.  A rank's shard is the FSDP cut of its TP
    cut."""
    size: int
    index: int
    shapes: Dict[str, tuple]
    splits: Dict[str, Optional[Split]]
    fsdp_size: int = 1
    fsdp_index: int = 0
    fsdp: Dict[str, Optional[int]] = dataclasses.field(default_factory=dict)

    def fsdp_dim(self, name: str) -> Optional[int]:
        return self.fsdp.get(name)

    def is_split(self, name: str) -> bool:
        """Whether a rank holds only part of leaf ``name``."""
        return (self.splits.get(name) is not None
                or self.fsdp.get(name) is not None)

    def shard_shape(self, name: str) -> tuple:
        shape = list(self.shapes[name])
        s = self.splits.get(name)
        if s is not None:
            shape[s.dim] = s.length(shape[s.dim], self.size)
        d = self.fsdp.get(name)
        if d is not None:
            shape[d] //= self.fsdp_size
        return tuple(shape)

    def shard(self, name: str, t: torch.Tensor,
              index: Optional[int] = None,
              fsdp_index: Optional[int] = None) -> torch.Tensor:
        """The shard at TP coordinate ``index`` and FSDP coordinate
        ``fsdp_index`` (this rank's by default) of a whole leaf ``t`` (any
        leading dims); the leaf itself where replicated."""
        s = self.splits.get(name)
        if s is not None:
            t = s.cut(t, self.size, self.index if index is None
                      else int(index))
        d = self.fsdp.get(name)
        if d is not None:
            i = self.fsdp_index if fsdp_index is None else int(fsdp_index)
            n = t.shape[d] // self.fsdp_size
            t = t.narrow(d, i * n, n)
        return t

    def unshard(self, name: str, parts) -> torch.Tensor:
        """The whole leaf from the shards of a worker's ranks, row-major
        over (FSDP, TP) coordinates: ``fsdp_size × size`` of them (a
        replicated leaf: the first's)."""
        parts = list(parts)
        d = self.fsdp.get(name)
        tp = []
        for j in range(self.size):
            col = parts[j::self.size]
            tp.append(torch.cat(col, dim=d) if d is not None else col[0])
        s = self.splits.get(name)
        return s.join(tp) if s is not None else tp[0]


def shard_plan(cfg, shapes: Dict[str, tuple], size: int, index: int = 0,
               fsdp_size: int = 1, fsdp_index: int = 0) -> ShardPlan:
    """The plan of a model of config ``cfg`` with whole per-worker leaf
    ``shapes`` (``Model.param_shapes(whole=True)``), over a model axis of
    ``size`` and an FSDP axis of ``fsdp_size``.  Raises ``ValueError``
    naming each field away from its default that no split is written for:
    DeepSeek-V2's expert layer (``PORT_ONLY``) and MLA's direct query."""
    from repro_torch.configs.base import PORT_ONLY
    bad = [f for f, default in PORT_ONLY.items()
           if getattr(cfg, f, default) != default]
    if getattr(cfg, "use_mla", False) and not cfg.q_lora_rank:
        bad.append("q_lora_rank")
    if bad:
        raise ValueError(f"shard_plan: no split for {', '.join(bad)} "
                         f"(the sharded backend takes them at their "
                         f"defaults)")
    return ShardPlan(int(size), int(index), dict(shapes),
                     {n: param_split(n, cfg, int(size)) for n in shapes},
                     int(fsdp_size), int(fsdp_index),
                     {n: fsdp_split(n, s, int(fsdp_size))
                      for n, s in shapes.items()})


# --------------------------------------------------------------- serving cache
def _cache_split(leaf: str, mixer: str, cfg, size: int) -> Optional[Split]:
    """A stacked cache leaf's split over a model axis of ``size``."""
    if size == 1:
        return None
    if mixer == "attn" and leaf in ("k", "v"):
        return Split(-2) if cfg.n_kv_heads % size == 0 else None
    if mixer == "mamba" and leaf == "ssm":
        by_heads = _ssd_split("A_log", "mamba", cfg, size) is not None
        return Split(-3) if by_heads else None
    if mixer == "mamba" and leaf == "conv":
        return _ssd_split("conv_w", "mamba", cfg, size)
    return None


@dataclasses.dataclass(frozen=True)
class CachePlan:
    """The serving cache's layout on this rank: each leaf's TP split
    (``splits[f"pos{i}"][leaf]``) over a model axis of ``tp_size`` (this
    rank at ``tp_index``), and whether the batch dim (dim 1 of a leaf
    stacked over the repeats) splits over ``batch_size`` ranks (this one
    at ``batch_index``)."""
    splits: Dict[str, Dict[str, Optional[Split]]]
    batch_split: bool
    batch_size: int = 1
    batch_index: int = 0
    tp_size: int = 1
    tp_index: int = 0

    def rows(self, batch: int) -> slice:
        """This rank's rows of a batch of ``batch``."""
        if not self.batch_split:
            return slice(0, batch)
        n = batch // self.batch_size
        return slice(self.batch_index * n, (self.batch_index + 1) * n)

    def shard(self, cache: dict) -> dict:
        """This rank's piece of a whole (one-rank) ``cache``."""
        out = {}
        for pos, leaves in cache.items():
            out[pos] = {}
            for leaf, t in leaves.items():
                t = t[:, self.rows(t.shape[1])]
                split = self.splits[pos][leaf]
                if split is not None:
                    t = split.cut(t, self.tp_size, self.tp_index)
                out[pos][leaf] = t
        return out


def cache_spec_tree(cfg, layout, batch: int) -> CachePlan:
    """The cache plan of a model of config ``cfg`` served on ``layout``
    (``make_layout(..., serving=True)``) at a global ``batch``."""
    baxes = layout.batch_axes
    bsize = layout.mesh.size(baxes) if baxes else 1
    tp = layout.axis_size(layout.tp_axis)
    splits = {}
    for i, spec in enumerate(cfg.pattern):
        leaves = {"attn": ("k", "v", "pos"), "mla": ("ckv", "krope", "pos"),
                  "mamba": ("ssm", "conv")}[spec.mixer]
        splits[f"pos{i}"] = {leaf: _cache_split(leaf, spec.mixer, cfg, tp)
                             for leaf in leaves}
    return CachePlan(splits, bool(baxes) and batch % bsize == 0, bsize,
                     layout.mesh.index(baxes) if baxes else 0, tp,
                     layout.axis_coord(layout.tp_axis))
