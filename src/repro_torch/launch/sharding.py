"""The tensor-parallel plan: which dim of each param leaf splits over the
model axis inside a worker.

Port of the model-axis half of ``param_pspec`` and ``_fit``
(``src/repro/launch/sharding.py:87-147``), profile A.  The reference hands
its specs to GSPMD, which inserts the collectives; the port runs
Megatron-style manual TP (:mod:`repro_torch.models.layers`), so a leaf
splits only where the module it belongs to can run on the split:

* column-parallel (the last dim): ``wq``, ``wk``, ``wv`` and their biases,
  ``wi``, ``wg`` (dense MLP and the MoE experts' f);
* row-parallel (the dim before it): ``attn.wo``, ``mlp.wo``, the experts'
  ``wo`` (E, f, d);
* over the vocab: ``embed.table`` (its rows) and ``lm_head.w`` (its
  columns);
* replicated: the router, the norms, every other leaf.

A dim that does not divide stays replicated, as ``_fit`` does, with the
unit the module splits by: attention's four leaves split together when the
KV heads divide (a query head group never straddles two ranks), the MLP's
when ``d_ff`` does, the vocab leaves when the vocab does, the experts'
when their f does.  The MLA and Mamba-2 leaves get the reference's specs
by divisibility alone; the models refuse those mixers under a model axis
above 1 (ROADMAP queue A item 12b.4).

The reference's ``make_shd`` hints (``src/repro/launch/runtime.py:62-109``:
``attn_ctx_shard``, ``moe_token_shard``) are GSPMD sharding constraints
and change no value.  Manual TP already shards attention by heads, and
token sharding over an FSDP axis is profile B's, so the port accepts the
flags and does nothing with them.

Split dims are negative, so a plan applies alike to one worker's leaf, to
a leaf with the worker dim of 1 and to a K-stacked one.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Optional

import torch

__all__ = ["TPPlan", "param_split", "tp_plan"]

_COLUMN = ("wq", "wk", "wv", "wi", "wg", "wdq", "wuq", "wdkv", "wuk", "wuv",
           "in_proj")
_ROW = ("wo", "out_proj")


def _divides(shape, dim: int, size: int) -> Optional[int]:
    return dim if shape[dim] % size == 0 else None


def param_split(name: str, shape, cfg, size: int) -> Optional[int]:
    """The dim of leaf ``name`` (the port's dotted key, ``shape`` its
    per-worker shape, blocks with their leading repeats) that splits over
    a model axis of ``size``, or None (replicated)."""
    if size == 1:
        return None
    parts = name.split(".")
    leaf, owner = parts[-1], parts[-2] if len(parts) > 1 else ""
    if name == "embed.table":
        return -2 if cfg.vocab % size == 0 else None
    if name == "lm_head.w":
        return -1 if cfg.vocab % size == 0 else None
    if ".moe." in name:
        if owner == "router" or cfg.d_ff % size:
            return None
        return {"wi": -1, "wg": -1, "wo": -2}.get(leaf)
    if ".attn." in name and owner in ("wq", "wk", "wv", "wo") \
            and not cfg.use_mla:
        if cfg.n_kv_heads % size:
            return None
        return -2 if owner == "wo" else -1
    if ".mlp." in name:
        if cfg.d_ff % size:
            return None
        return -2 if owner == "wo" else -1
    # MLA and Mamba-2: the reference's specs by divisibility alone
    if leaf == "w" and owner in _ROW:
        return _divides(shape, -2, size)
    if leaf == "w" and owner in _COLUMN:
        return _divides(shape, -1, size)
    if leaf in ("b", "conv_w"):
        return _divides(shape, -1, size)
    return None


@dataclasses.dataclass(frozen=True)
class TPPlan:
    """Every leaf's split dim over a model axis of ``size``, and this
    rank's coordinate ``index`` on it; ``shapes`` are the whole per-worker
    shapes."""
    size: int
    index: int
    shapes: Dict[str, tuple]
    splits: Dict[str, Optional[int]]

    def split_dim(self, name: str) -> Optional[int]:
        return self.splits.get(name)

    def shard_shape(self, name: str) -> tuple:
        shape = list(self.shapes[name])
        d = self.splits[name]
        if d is not None:
            shape[d] //= self.size
        return tuple(shape)

    def shard(self, name: str, t: torch.Tensor,
              index: Optional[int] = None) -> torch.Tensor:
        """Coordinate ``index``'s (this rank's by default) slice of a whole
        leaf ``t`` (any leading dims); the leaf itself where replicated."""
        d = self.splits.get(name)
        if d is None:
            return t
        i = self.index if index is None else int(index)
        n = t.shape[d] // self.size
        return t.narrow(d, i * n, n)

    def unshard(self, name: str, parts) -> torch.Tensor:
        """The whole leaf from the shards of coordinates 0 … size−1 (a
        replicated leaf: coordinate 0's)."""
        d = self.splits.get(name)
        if d is None:
            return parts[0]
        return torch.cat(list(parts), dim=d)


def tp_plan(cfg, shapes: Dict[str, tuple], size: int,
            index: int = 0) -> TPPlan:
    """The plan of a model of config ``cfg`` with whole per-worker leaf
    ``shapes`` (``Model.param_shapes`` at a model axis of 1)."""
    return TPPlan(int(size), int(index), dict(shapes),
                  {n: param_split(n, s, cfg, int(size))
                   for n, s in shapes.items()})
