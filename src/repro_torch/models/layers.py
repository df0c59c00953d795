"""Shared neural-net layers: pure functions over dicts of tensors.

Port of ``src/repro/models/layers.py:21-127``.  Each function takes its
params as a dict named as the reference's (``{"w", "b"}`` for a dense
layer, ``{"scale", "bias"}`` for a norm, ``{"table"}`` for an embedding,
``{"wi", "wo", "wg"}`` for an MLP), so the modules of
:mod:`repro_torch.models.transformer` hand them the tensors that
``torch.func.functional_call`` put in place.

Conventions kept from the reference:

* matmuls accumulate in f32 and cast back to the input's dtype, the bias
  added in f32 before the cast;
* RMSNorm uses eps 1e-6, LayerNorm and OLMo's non-parametric LayerNorm
  eps 1e-5 and the biased variance, all three ``rsqrt``;
* RoPE rotates the two halves of the head dim (not interleaved pairs),
  from f32 tables read at ``positions``;
* the non-gated MLP uses GELU's tanh form (``jax.nn.gelu``'s default),
  the gated one SiLU.

Initial values match the reference's distributions, not its bits: a
standard normal truncated to [−2, 2] in f32 times ``scale``, then cast.

Tensor parallelism inside a worker (the model axis of profiles A and B;
which leaf splits is :mod:`repro_torch.launch.sharding`'s plan): a
:class:`TPGroup` names the ranks of one worker and their ``all_reduce``,
and two autograd functions carry the Megatron pair of collectives,

* :func:`copy_to_model`: identity forward, ``all_reduce`` of the gradient
  backward (the replicated input of a column-parallel product);
* :func:`reduce_from_model`: ``all_reduce`` forward, identity backward (the
  partial sums of a row-parallel product);

on which :func:`row_dense`, the vocab-parallel :func:`embed` (a masked
lookup, then the sum: exact, one summand is non-zero) and
:func:`vocab_parallel_nll` (the max and Σexp reduced, the label's logit
picked on the rank that owns it) are built; :func:`sum_over_model` is
both at once (a sum every rank's slice reads: ``all_reduce`` forward and
backward, the SSD's gated norm).  With ``tp`` None or of size 1 every
function is the one-rank formula, op for op.

FSDP inside a worker (profile B's data axis) uses the same group type
with an ``all_gather`` and a ``reduce_scatter``: :func:`gather_from_data`
all-gathers a leaf's shards where the leaf is used, and its backward
sums the gradient over the data ranks and keeps this rank's slice, leaf
by leaf as autograd reaches them.  Its ``reduce`` flag is False where
every data rank ran the whole batch: the gradients are then equal and
are not summed.
"""
from __future__ import annotations

import dataclasses
from typing import Callable

import torch
import torch.distributed as dist
import torch.nn.functional as F

__all__ = [
    "dense", "rmsnorm", "layernorm", "nonparametric_layernorm", "embed",
    "rope_freqs", "apply_rope", "mlp", "truncated_normal", "TPGroup",
    "copy_to_model", "reduce_from_model", "row_dense", "vocab_parallel_nll",
    "sum_over_model", "gather_from_data",
]


# ------------------------------------------------------------------ TP group
@dataclasses.dataclass(frozen=True, eq=False)
class TPGroup:
    """The ranks of one worker on one of its inner axes (the model axis,
    the FSDP axis or the inner data-parallel axis): ``size`` of them, this
    one at ``index``; ``all_reduce(t, op)`` reduces ``t`` in place over
    them, ``all_gather(t, dim)`` concatenates their ``t`` along ``dim``
    and ``reduce_scatter(t, dim)`` is this rank's slice of their sum (the
    mesh's, staged through host buffers on a card under gloo)."""
    size: int
    index: int
    all_reduce: Callable
    all_gather: Callable = None
    reduce_scatter: Callable = None


def tp_active(tp) -> bool:
    return tp is not None and tp.size > 1


class _CopyToModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, tp):
        ctx.tp = tp
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return ctx.tp.all_reduce(g.contiguous().clone(),
                                 dist.ReduceOp.SUM), None


class _ReduceFromModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, tp):
        return tp.all_reduce(x.contiguous().clone(), dist.ReduceOp.SUM)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _GatherFromData(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, dim, reduce):
        ctx.group, ctx.dim, ctx.reduce = group, dim, reduce
        return group.all_gather(x, dim)

    @staticmethod
    def backward(ctx, g):
        grp, dim = ctx.group, ctx.dim
        if ctx.reduce:
            return grp.reduce_scatter(g, dim), None, None, None
        n = g.shape[dim] // grp.size
        return g.narrow(dim, grp.index * n, n).clone(), None, None, None


def gather_from_data(x: torch.Tensor, group, dim: int,
                     reduce: bool = True) -> torch.Tensor:
    """The whole leaf from this rank's shard ``x`` (split on ``dim`` over
    the FSDP ``group``); backward, the gradient summed over the group
    (``reduce``) and cut to this rank's slice."""
    return _GatherFromData.apply(x, group, dim, reduce)


def sum_over_model(x: torch.Tensor, tp) -> torch.Tensor:
    """The sum of ``x`` over the worker's ranks, where every rank's slice
    reads the sum: the gradient is summed over the ranks too."""
    return reduce_from_model(copy_to_model(x, tp), tp)


def copy_to_model(x: torch.Tensor, tp) -> torch.Tensor:
    """``x`` as it is; its gradient summed over the worker's ranks."""
    return _CopyToModel.apply(x, tp) if tp_active(tp) else x


def reduce_from_model(x: torch.Tensor, tp) -> torch.Tensor:
    """The sum of ``x`` over the worker's ranks; the gradient as it is."""
    return _ReduceFromModel.apply(x, tp) if tp_active(tp) else x


def truncated_normal(shape, dtype, scale: float,
                     generator: torch.Generator) -> torch.Tensor:
    """``scale`` × a standard normal truncated to [−2, 2], drawn in f32 on
    the generator's device, cast to ``dtype``."""
    t = torch.empty(shape, dtype=torch.float32, device=generator.device)
    torch.nn.init.trunc_normal_(t, mean=0.0, std=1.0, a=-2.0, b=2.0,
                                generator=generator)
    return (scale * t).to(dtype)


# ---------------------------------------------------------------------------- dense
def dense(p: dict, x: torch.Tensor) -> torch.Tensor:
    """``x @ w (+ b)`` accumulated in f32, cast back to ``x``'s dtype."""
    y = torch.matmul(x.to(torch.float32), p["w"].to(torch.float32))
    if "b" in p:
        y = y + p["b"].to(torch.float32)
    return y.to(x.dtype)


def row_dense(p: dict, x: torch.Tensor, tp=None) -> torch.Tensor:
    """:func:`dense` of a row-parallel ``w`` (its rows split over the
    worker's ranks, ``x`` their columns): the partial products summed over
    the ranks in f32, then the bias and the cast."""
    y = reduce_from_model(torch.matmul(x.to(torch.float32),
                                       p["w"].to(torch.float32)), tp)
    if "b" in p:
        y = y + p["b"].to(torch.float32)
    return y.to(x.dtype)


# ---------------------------------------------------------------------------- norms
def rmsnorm(p: dict, x: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    x32 = x.to(torch.float32)
    var = torch.mean(x32 * x32, dim=-1, keepdim=True)
    y = x32 * torch.rsqrt(var + eps)
    return (y * p["scale"].to(torch.float32)).to(x.dtype)


def _normalize(x32: torch.Tensor, eps: float) -> torch.Tensor:
    mean = torch.mean(x32, dim=-1, keepdim=True)
    var = torch.mean((x32 - mean) ** 2, dim=-1, keepdim=True)
    return (x32 - mean) * torch.rsqrt(var + eps)


def layernorm(p: dict, x: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    y = _normalize(x.to(torch.float32), eps) * p["scale"].to(torch.float32)
    if "bias" in p:
        y = y + p["bias"].to(torch.float32)
    return y.to(x.dtype)


def nonparametric_layernorm(x: torch.Tensor, eps: float = 1e-5):
    """OLMo's non-parametric LayerNorm (no scale/bias; arXiv:2402.00838)."""
    return _normalize(x.to(torch.float32), eps).to(x.dtype)


# ---------------------------------------------------------------------------- embed
def embed(p: dict, tokens: torch.Tensor, tp=None) -> torch.Tensor:
    """Rows of ``p["table"]`` at integer ``tokens``; under ``tp`` the table
    holds this rank's slice of the vocab: the rows it owns, zeros for the
    rest, summed over the worker's ranks."""
    if not tp_active(tp):
        return F.embedding(tokens.long(), p["table"])
    n = p["table"].shape[0]
    t = tokens.long() - tp.index * n
    own = (t >= 0) & (t < n)
    rows = F.embedding(t.clamp(0, n - 1), p["table"])
    rows = torch.where(own[..., None], rows,
                       torch.zeros((), dtype=rows.dtype, device=rows.device))
    return reduce_from_model(rows, tp)


def vocab_parallel_nll(logits: torch.Tensor, labels: torch.Tensor,
                       tp) -> torch.Tensor:
    """``−log softmax(logits)[label]`` (labels clamped at 0) where each
    rank holds its slice of the vocab's f32 ``logits``: the max and Σexp
    over the vocab reduced over the worker's ranks, the label's logit
    taken on the rank that owns it (zero elsewhere) and summed."""
    n = logits.shape[-1]
    m = logits.detach().amax(-1, keepdim=True)
    m = tp.all_reduce(m.contiguous(), dist.ReduceOp.MAX)
    z = logits - m
    sumexp = reduce_from_model(torch.exp(z).sum(-1), tp)
    t = labels.clamp_min(0) - tp.index * n
    own = (t >= 0) & (t < n)
    picked = z.gather(-1, t.clamp(0, n - 1)[..., None])[..., 0]
    picked = torch.where(own, picked,
                         torch.zeros((), dtype=z.dtype, device=z.device))
    return torch.log(sumexp) - reduce_from_model(picked, tp)


# ---------------------------------------------------------------------------- rope
def rope_freqs(head_dim: int, max_len: int, theta: float = 10000.0,
               device=None):
    """(max_len, head_dim/2) cos and sin tables, f32."""
    inv = 1.0 / (theta ** (torch.arange(0, head_dim, 2, dtype=torch.float32,
                                        device=device) / head_dim))
    t = torch.arange(max_len, dtype=torch.float32, device=device)
    f = torch.outer(t, inv)
    return torch.cos(f), torch.sin(f)


def apply_rope(x, cos, sin, positions):
    """x: (..., seq, heads, head_dim); positions: (..., seq) integers."""
    c = cos[positions].unsqueeze(-2)   # (..., seq, 1, hd/2)
    s = sin[positions].unsqueeze(-2)
    x1, x2 = torch.chunk(x.to(torch.float32), 2, dim=-1)
    out = torch.cat([x1 * c - x2 * s, x2 * c + x1 * s], dim=-1)
    return out.to(x.dtype)


# ---------------------------------------------------------------------------- mlp
def mlp(p: dict, x: torch.Tensor, tp=None) -> torch.Tensor:
    """Gated SiLU MLP when ``p`` has ``wg``, else GELU (tanh form); under
    ``tp`` ``wi``/``wg`` column-parallel and ``wo`` row-parallel."""
    x = copy_to_model(x, tp)
    h = dense(p["wi"], x)
    if "wg" in p:
        h = F.silu(dense(p["wg"], x).to(torch.float32)).to(x.dtype) * h
    else:
        h = F.gelu(h.to(torch.float32), approximate="tanh").to(x.dtype)
    if tp_active(tp):
        return row_dense(p["wo"], h, tp)
    return dense(p["wo"], h)
