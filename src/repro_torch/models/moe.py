"""Mixture-of-Experts layer: top-k router and sort-based capacity dispatch.

Port of ``src/repro/models/moe.py``.  The dispatch is sort-based, as in
the reference: the N·k (token, expert) slots are sorted by expert, each
slot's rank within its expert comes from the expert counts' exclusive
cumsum, and slots at rank ≥ C are dropped (Switch semantics).  The
``(E, C, d)`` capacity buffer then feeds the expert FFN, three batched
matmuls over the experts (``torch.matmul``, as the reference leaves them
to ``jnp.einsum``), and each kept slot's output is added back to its
token, weighted by its renormalised gate.

The functions run under ``torch.func.vmap(grad_and_value)`` over stacked
workers, which shapes how they are written: the capacity C is a Python
int from the shapes; the counts are a one-hot sum, not ``bincount``; the
buffer is a gather of the sorted slots (``buf[e, c]`` is the token of
sorted slot ``start[e] + c`` where ``c < count[e]``, else zero), which
writes what the reference's ``.at[].set(mode="drop")`` writes; the
combine reads a dropped slot at rank C − 1, as the reference's clipped
gather does, and masks it with ``where``, so no gradient reaches it; the
token sum is an out-of-place ``index_add``.  Nothing on that path reads
a tensor on the host.

Ties: ``lax.top_k`` breaks a tie in the gates by the lower expert index;
``torch.topk`` promises no order for ties.  Gates tie only where router
logits tie, so the two pick the same experts on any input whose logits
differ (the tests draw such inputs).

The grouped dispatch (``n_groups`` G > 1) sorts each group of N/G tokens
on its own at capacity ``C(N/G)`` and runs the experts on the groups'
buffers side by side, ``(E, G·C, d)``; with G = 1 it is the global sort.
``N % G ≠ 0`` falls back to one group, as in the reference.

Under tensor parallelism (``tp``) the experts' f dim is split over the
worker's ranks (``wi``/``wg`` (E, d, f/tp), ``wo`` (E, f/tp, d)): every
rank routes and dispatches the same tokens with the replicated router,
runs its slice of every expert's FFN, and the partial outputs are summed
over the ranks before the combine.

Where a worker's batch is split over ranks (``inner``: profile B's FSDP
axis, or profile A's ``inner="dp"`` axis) each rank routes and dispatches
its own tokens only, and the layer still computes the worker's function.
The aux loss is ``E·Σ f_e·P_e`` over the worker's tokens: ``f_e``'s counts
are summed over the ranks, and each rank adds its tokens' share of
``P_e`` (its gates' sum over the worker's N), so the ranks' aux losses sum
to the worker's, gradient included.  The capacity, and so which slots
drop, follows the worker's tokens and dispatch groups: the ranks
all-gather their slot counts per (group, expert), and a slot's rank in
its expert is its rank among this rank's slots plus the exclusive prefix
of the earlier ranks' counts (:func:`dispatch_rank`), so its kept slots
are the reference's.  The rank's buffer holds only its own kept slots,
``(E, M, d)`` with M the most that one expert keeps of them, so the
experts run about 1/D of the worker's rows on each of D ranks.  M is
read on the host once a call: this path runs in plain autograd on the
sharded backend, never under ``vmap``.

DeepSeek-V2's expert layer adds four things, each off by default:

* ``d_ff`` is the experts' width, which may differ from the dense MLP's;
* ``n_shared`` shared experts, one gated MLP of width ``n_shared·d_ff``
  (``params["shared"]``, as :func:`repro_torch.models.layers.mlp` takes
  it) on every token, added to the routed sum;
* ``norm_topk`` False: the slots are weighted by their gates as the
  softmax gave them, not renormalised over the top-k;
* ``held`` experts ``first … first + held − 1`` of the ``n_experts`` the
  router scores: a card's share of a layer divided over several by
  expert parallelism.  The router, its top-k and the capacity C (of
  ``n_experts``) are the whole layer's, so a slot's rank in its expert
  is what it would be on any card; the buffer and the expert products
  cover the held experts alone (``wi``/``wg``/``wo`` hold ``held``
  experts), and a slot routed to another expert adds nothing.  The
  output is this card's part of the layer: the shares of all cards,
  with the shared experts counted once, sum to the whole layer's.  The
  sharded backend (``inner``) holds every expert.

The layer's steps run inside the spans :data:`repro_torch.spans.MOE_ROUTE`
(router and load-balance loss), :data:`~repro_torch.spans.MOE_DISPATCH`,
:data:`~repro_torch.spans.MOE_EXPERTS` (routed and shared products) and
:data:`~repro_torch.spans.MOE_COMBINE`, and each call counts its slots
and its expert rows (:func:`repro_torch.spans.counters`).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Optional

import torch
import torch.distributed as dist
import torch.nn.functional as F

from repro_torch import spans
from repro_torch.models.layers import (copy_to_model, dense, mlp,
                                       reduce_from_model)
from repro_torch.spans import (MOE_COMBINE, MOE_DISPATCH, MOE_EXPERTS,
                               MOE_ROUTE, span)

__all__ = ["MoECfg", "moe_apply", "capacity", "route", "dispatch",
           "dispatch_rank"]


@dataclasses.dataclass(frozen=True)
class MoECfg:
    d_model: int
    d_ff: int
    n_experts: int
    top_k: int = 2
    capacity_factor: float = 1.25
    router_aux_weight: float = 0.01
    gated: bool = True
    n_groups: int = 1           # 1: one global sort; G: per-group sorts
    n_shared: int = 0           # shared experts, of width d_ff each
    held: Optional[int] = None  # experts held here (None: n_experts)
    first: int = 0              # the first held expert's id
    norm_topk: bool = True      # renormalise the top-k gates

    def __post_init__(self):
        if not 0 <= self.first <= self.first + self.n_held <= \
                self.n_experts:
            raise ValueError(f"experts {self.first} … "
                             f"{self.first + self.n_held - 1} held of "
                             f"{self.n_experts}")

    @property
    def n_held(self) -> int:
        return self.n_experts if self.held is None else self.held

    @property
    def partial(self) -> bool:
        """Whether some routed experts lie elsewhere."""
        return self.n_held < self.n_experts


def capacity(n_tokens: int, cfg: MoECfg) -> int:
    """Slots an expert takes: ceil(k·N/E·cf) rounded up to 8, at least 8."""
    c = math.ceil(cfg.top_k * n_tokens / cfg.n_experts * cfg.capacity_factor)
    return max(8, -(-c // 8) * 8)


def _slot_weights(top_w, cfg: MoECfg):
    """Each slot's weight: its gate, renormalised over the token's top-k
    unless ``norm_topk`` is off."""
    if not cfg.norm_topk:
        return top_w
    return top_w / torch.clamp_min(top_w.sum(-1, keepdim=True), 1e-9)


def dispatch(xg, top_w, top_e, C: int, cfg: MoECfg):
    """Sort-based dispatch of G groups at once.

    xg: (G, n, d); top_w, top_e: (G, n, k), the gates' top-k.  Returns the
    (G, H, C, d) buffer of the H held experts and the combine metadata
    ``(sorted_e, rank, token_of_slot, w_of_slot, keep)``, each (G, n·k) in
    the sorted slot order (``sorted_e`` the held expert's index, from
    ``first``); ``keep`` is False on the dropped slots and on those routed
    to experts not held.
    """
    G, n, d = xg.shape
    k, E = cfg.top_k, cfg.n_experts
    dev = xg.device
    top_w = _slot_weights(top_w, cfg)
    flat_e = top_e.reshape(G, n * k)
    order = torch.argsort(flat_e, dim=-1, stable=True)          # (G, n·k)
    sorted_e = torch.gather(flat_e, -1, order)
    token_of_slot = order // k
    w_of_slot = torch.gather(top_w.reshape(G, n * k), -1, order)
    experts = torch.arange(E, device=dev)
    counts = (flat_e[..., None] == experts).to(torch.int64).sum(-2)  # (G, E)
    starts = torch.cumsum(counts, -1) - counts
    rank = (torch.arange(n * k, device=dev)
            - torch.gather(starts, -1, sorted_e))
    keep = rank < C
    H = cfg.n_held
    if cfg.partial:
        # the held experts' counts and starts; the others' slots drop
        lo = cfg.first
        counts, starts = counts[:, lo:lo + H], starts[:, lo:lo + H]
        local = sorted_e - lo
        here = (local >= 0) & (local < H)
        keep = keep & here
        # a slot elsewhere reads held expert 0 at rank C − 1 and is masked
        sorted_e = torch.where(here, local, 0)
    # buf[g, e, c] is sorted slot starts[e] + c where c < counts[e]
    slots = torch.arange(C, device=dev)
    valid = slots < counts[..., None]                            # (G, H, C)
    pos = torch.where(valid, starts[..., None] + slots, 0).reshape(G, H * C)
    tok = torch.gather(token_of_slot, -1, pos)
    base = (torch.arange(G, device=dev) * n)[:, None]
    rows = torch.index_select(xg.reshape(G * n, d), 0,
                              (tok + base).reshape(-1))
    buf = torch.where(valid.reshape(G * H * C, 1), rows,
                      torch.zeros((), dtype=xg.dtype, device=dev))
    meta = (sorted_e, rank, token_of_slot, w_of_slot, keep)
    return buf.reshape(G, H, C, d), meta


def _combine(out_buf, meta, n: int):
    """out_buf: (G, E, C, d) → (G, n, d) f32: each kept slot's output
    times its gate, added to its token."""
    sorted_e, rank, token_of_slot, w_of_slot, keep = meta
    G, E, C, d = out_buf.shape
    dev = out_buf.device
    rank_c = torch.where(keep, rank, C - 1)      # the reference's clip
    base = (torch.arange(G, device=dev) * (E * C))[:, None]
    slot_out = torch.index_select(out_buf.reshape(G * E * C, d), 0,
                                  (sorted_e * C + rank_c + base).reshape(-1))
    slot_out = torch.where(keep.reshape(-1, 1), slot_out,
                           torch.zeros((), dtype=out_buf.dtype, device=dev))
    slot_out = slot_out.to(torch.float32) * w_of_slot.reshape(-1, 1)
    tbase = (torch.arange(G, device=dev) * n)[:, None]
    y = torch.zeros((G * n, d), dtype=torch.float32, device=dev).index_add(
        0, (token_of_slot + tbase).reshape(-1), slot_out)
    return y.reshape(G, n, d)


def _expert_ffn(params, buf, tp=None):
    """buf: (E, T, d) → (E, T, d); gated SiLU (GELU's tanh form when
    ungated), accumulated in f32; under ``tp`` this rank's slice of f, the
    output summed over the worker's ranks in f32."""
    x32 = copy_to_model(buf, tp).to(torch.float32)
    h = torch.matmul(x32, params["wi"].to(torch.float32))
    if "wg" in params:
        h = F.silu(torch.matmul(x32, params["wg"].to(torch.float32))) * h
    else:
        h = F.gelu(h, approximate="tanh")
    h = h.to(buf.dtype)
    out = torch.matmul(h.to(torch.float32), params["wo"].to(torch.float32))
    return reduce_from_model(out, tp).to(buf.dtype)


def route(params, xf, cfg: MoECfg):
    """The router on tokens ``xf`` (N, d), in f32 throughout: the gates
    (N, E) and their top-k values and expert ids (N, k), before the
    renormalisation."""
    logits = dense(params["router"], xf.to(torch.float32))
    gates = torch.softmax(logits.to(torch.float32), dim=-1)
    top_w, top_e = torch.topk(gates, cfg.top_k, dim=-1)
    return gates, top_w, top_e


def _groups(n_tokens: int, cfg: MoECfg):
    """The dispatch groups of ``n_tokens``: ``(G, tokens a group)``; one
    group where ``n_groups`` does not divide them, as in the reference."""
    G = cfg.n_groups if n_tokens % max(cfg.n_groups, 1) == 0 else 1
    return G, n_tokens // G


def slot_keys(top_e, first: int, G: int, n: int, cfg: MoECfg):
    """Each of this rank's slots' (expert, group) key ``e·G + g``, (N·k,):
    ``top_e`` (N, k) of tokens at the worker's positions ``first``,
    ``first + 1``, ..., in groups of ``n``; and its count per key, (E·G,)."""
    N, k = top_e.shape
    dev = top_e.device
    g = (first + torch.arange(N, device=dev)) // n
    key = (top_e * G + g[:, None]).reshape(N * k)
    counts = (key[:, None] == torch.arange(cfg.n_experts * G, device=dev)
              ).to(torch.int64).sum(0)
    return key, counts


def dispatch_rank(xf, top_w, key, counts, before, C: int, G: int,
                  cfg: MoECfg):
    """Dispatch of this rank's tokens ``xf`` (N, d) when the worker's
    batch is split: ``top_w`` (N, k) the gates' top-k, ``key``/``counts``
    from :func:`slot_keys`, ``before`` (E·G,) the slots of each key on the
    worker's earlier ranks.  A slot's rank in its group's expert is
    ``before`` plus its rank among this rank's slots of the key (in token
    order, as the reference's stable sort orders them), kept below C.
    Returns the (E, M, d) buffer of this rank's kept slots, expert-major
    and in that order within an expert (``min(G·C, N·k)`` rows an
    expert, zero past its kept slots), and the combine metadata
    ``(sorted_e, pos, token_of_slot, w_of_slot, keep)``, each (1, N·k) in
    the sorted slot order (``pos``: the slot's row in its expert)."""
    N, d = xf.shape
    k, E = cfg.top_k, cfg.n_experts
    dev = xf.device
    top_w = _slot_weights(top_w, cfg)
    order = torch.argsort(key, stable=True)
    sorted_key = key[order]
    token_of_slot = order // k
    w_of_slot = top_w.reshape(N * k)[order]
    starts = torch.cumsum(counts, 0) - counts
    local = torch.arange(N * k, device=dev) - starts[sorted_key]
    keep = before[sorted_key] + local < C
    # the kept slots of a key are a prefix of its run; an expert's rows
    # are its groups' kept slots, group after group
    kept = torch.clamp(torch.minimum(C - before, counts), min=0)
    per_e = kept.reshape(E, G)
    kstart = (torch.cumsum(per_e, 1) - per_e).reshape(E * G)
    # an expert's rows: a static bound on its kept slots here (at most C a
    # group, and at most the rank's N·k slots), so no count is read on the
    # host; the rows past an expert's kept slots stay zero and are never
    # combined
    M = min(G * C, N * k)
    sorted_e = sorted_key // G
    pos = kstart[sorted_key] + local
    row = torch.where(keep, sorted_e * M + pos, E * M)  # E·M: dropped
    buf = xf.new_zeros(E * M + 1, d).index_copy(0, row, xf[token_of_slot])
    meta = tuple(t[None] for t in (sorted_e, pos, token_of_slot, w_of_slot,
                                   keep))
    return buf[:E * M].reshape(E, M, d), meta


def moe_apply(params, x, cfg: MoECfg, tp=None, inner=None):
    """x: (b, s, d) → (y, aux_loss); ``params`` as the reference's
    ``{"router": {"w"}, "wi", "wg", "wo"}`` (under ``tp`` the experts'
    slices of f), with ``"shared"`` (``{"wi", "wg", "wo"}``, each
    ``{"w"}``) where ``n_shared`` > 0.  ``inner``: the group of ranks over
    which the worker's batch is split (this rank's aux loss is then its
    share)."""
    b, s, d = x.shape
    N = b * s
    E, k = cfg.n_experts, cfg.top_k
    xf = x.reshape(N, d)

    with span(MOE_ROUTE):
        gates, top_w, top_e = route(params, xf, cfg)

        # the Switch load-balance loss: w · E · Σ_e P_e f_e
        ones = (top_e[..., None] == torch.arange(E, device=x.device)).to(
            torch.float32).sum(-2)
        if inner is None:
            P_e = gates.mean(0)
            f_e = ones.mean(0) / k
        else:
            Nw = N * inner.size                    # the worker's tokens
            P_e = gates.sum(0) / Nw
            f_e = inner.all_reduce(ones.sum(0), dist.ReduceOp.SUM) / Nw / k
        aux = cfg.router_aux_weight * E * torch.sum(P_e * f_e)

    if inner is not None:
        if cfg.partial:
            raise ValueError("moe_apply: a split batch (inner) holds every "
                             "expert; held < n_experts is not supported")
        with span(MOE_DISPATCH):
            G, n = _groups(N * inner.size, cfg)
            key, counts = slot_keys(top_e, inner.index * N, G, n, cfg)
            # the slots of each (expert, group) on the worker's earlier
            # ranks
            before = inner.all_gather(counts[None], 0)[:inner.index].sum(0)
            buf, meta = dispatch_rank(xf, top_w, key, counts, before,
                                      capacity(n, cfg), G, cfg)
        with span(MOE_EXPERTS):
            out = _expert_ffn(params, buf, tp)
            shared = _shared(params, xf, cfg)
        with span(MOE_COMBINE):
            y = _combine(out[None], meta, N).reshape(N, d)
            y = _add_shared(y, shared)
        _count(N * k, buf.shape[0] * buf.shape[1])
        return y.reshape(b, s, d).to(x.dtype), aux

    G, n = _groups(N, cfg)
    C = capacity(n, cfg)
    H = cfg.n_held
    with span(MOE_DISPATCH):
        buf, meta = dispatch(xf.reshape(G, n, d), top_w.reshape(G, n, k),
                             top_e.reshape(G, n, k), C, cfg)
        ebuf = buf.transpose(0, 1).reshape(H, G * C, d)   # expert-major
    with span(MOE_EXPERTS):
        out = _expert_ffn(params, ebuf, tp).reshape(H, G, C, d).transpose(
            0, 1)
        shared = _shared(params, xf, cfg)
    with span(MOE_COMBINE):
        y = _combine(out, meta, n).reshape(N, d)
        y = _add_shared(y, shared)
    _count(N * k, H * G * C)
    return y.reshape(b, s, d).to(x.dtype), aux


def _shared(params, xf, cfg: MoECfg):
    """The shared experts' output on every token (None without them)."""
    return mlp(params["shared"], xf) if cfg.n_shared else None


def _add_shared(y, shared):
    return y if shared is None else y + shared.to(torch.float32)


def _count(slots: int, rows: int):
    """One call's counters, from its shapes alone."""
    spans.count(spans.MOE_CALLS)
    spans.count(spans.MOE_SLOTS, slots)
    spans.count(spans.MOE_EXPERT_ROWS, rows)
