"""Attention: GQA (+bias), sliding window, MLA, blockwise long sequences.

Port of the training half of ``src/repro/models/attention.py`` (GQA,
``:31-165``; MLA, ``:246-301``): plain PyTorch matmuls and a softmax, the
reference's formula step by step (the reference has no Pallas kernel
here).  Two execution paths:

* :func:`attend_full` — O(s²) scores under the causal (and window) mask;
* :func:`attend_blockwise` — a loop over query chunks, memory O(s·chunk);
  with a window each chunk reads a static KV band left-padded with
  positions −1, so the work drops to O(s·window).  Taken at
  ``s ≥ blockwise_threshold``, or forced.

GQA layout: q (b, s, n_heads, hd); k/v (b, s, n_kv, hd); the q heads are
grouped as (n_kv, group), so head h reads kv head ``h // group``.  Scores
are f32, scaled by ``head_dim ** -0.5``, masked entries filled with
:data:`NEG_INF` (a finite f32, not −inf), softmaxed in f32, and the
probabilities cast to v's dtype.

MLA (multi-head latent attention, MiniCPM3 / DeepSeek-V2): the queries
come from a low-rank ``wdq`` → RMSNorm ``q_norm`` → ``wuq``, or where
``q_lora_rank`` is 0 or None (DeepSeek-V2-Lite) from one direct ``wq``
(d, heads·(qk_nope_dim + qk_rope_dim)); the keys'
and values' shared latent from ``wdkv`` → RMSNorm ``kv_norm``, expanded
per head by ``wuk`` and ``wuv``; ``wkr`` gives one rotary key head of
``qk_rope_dim``, broadcast (``expand``, no copy) to every head after its
``qk_nope_dim`` part.  The scores are MHA's over ``qk_nope_dim +
qk_rope_dim`` (scale its ``-0.5`` power), the values ``v_head_dim`` wide:
:func:`attend_full` / :func:`attend_blockwise` on a ``dataclasses.replace``d
cfg, as the reference runs them.

Under tensor parallelism (``tp``, :class:`~repro_torch.models.layers.TPGroup`)
GQA runs Megatron's split: ``wq``, ``wk``, ``wv`` column-parallel, so each
rank holds ``n_heads/tp`` query and ``n_kv_heads/tp`` KV heads (whole
query groups; the window and the blockwise path are per head), and ``wo``
row-parallel, its partial products summed over the worker's ranks.  MLA
runs the same split by heads: ``wuq``, ``wuk`` and ``wuv`` column-parallel
(their columns are head-major), ``wo`` row-parallel, while ``wdq``,
``wdkv``, ``wkr`` and the two latent norms stay whole on every rank (every
head reads the latents whole).  Those replicated leaves feed only this
rank's heads, so the gradient of what they produce is summed over the
model axis exactly once, by :func:`copy_to_model` on ``cq``, ``ckv`` and
``k_rope``, and not on ``x``: their gradients are then whole and equal on
every rank.

Serving (reference ``:168-244`` and ``:303-353``): :func:`attention_prefill`
runs the full-sequence attention and packs its K/V into the decode cache
(:func:`_prompt_cache`); :func:`init_kv_cache` is that cache empty, and
:func:`attention_decode` attends one new position to it.  The cache is the
full ``max_len`` slots, or with a window a ring of ``min(window,
max_len)`` slots in which position p sits at slot ``p % slots``: a prompt
longer than the ring keeps its last ``slots`` positions, rolled by ``s mod
slots``, and an empty slot holds position −1.  Decode's mask is ``cpos ≥ 0
& cpos ≤ pos`` (and ``cpos > pos − window`` with a window).  MLA's cache
(:func:`mla_prefill`, :func:`init_mla_cache`, :func:`mla_decode`) is the
compressed one: the normed latent ``ckv`` (b, max_len, kv_lora_rank) and
the rotary key head ``krope`` (b, max_len, 1, qk_rope_dim), re-expanded
through ``wuk``/``wuv`` into every head's K and V at every step, as the
reference does.  Decode writes the new position into the cache in place
and returns the same dict (the reference's ``build_serve`` donates the
cache to its decode step; the port writes where the donated buffer
would be reused).  Under ``tp`` a rank's GQA cache holds its
``n_kv_heads/tp`` heads, and ``wo`` stays row-parallel; MLA's latents
stay whole on every rank and are expanded by the rank's heads.

The training pass of the MLA mixer (:func:`mla_apply`) runs inside the
span :data:`repro_torch.spans.ATTN_MLA`.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch
import torch.nn.functional as F

from repro_torch.models.layers import (apply_rope, copy_to_model, dense,
                                       rmsnorm, row_dense, tp_active)
from repro_torch.spans import ATTN_MLA, span

__all__ = ["AttnCfg", "attention_apply", "attention_prefill",
           "attention_decode", "init_kv_cache", "attend_full",
           "attend_blockwise", "mla_apply", "mla_prefill", "mla_decode",
           "init_mla_cache", "NEG_INF"]

NEG_INF = -1e30


@dataclasses.dataclass(frozen=True)
class AttnCfg:
    d_model: int
    n_heads: int
    n_kv_heads: int
    head_dim: int
    qkv_bias: bool = False          # qwen2
    window: Optional[int] = None    # sliding-window size (None = full causal)
    q_chunk: int = 1024      # blockwise query-chunk length  # lint: allow
    blockwise_threshold: int = 8192  # use blockwise when seq >= this
    rope_theta: float = 10000.0
    # MLA dims (minicpm3 / deepseek-v2 style); read by the MLA path only;
    # q_lora_rank 0 or None: a direct query
    q_lora_rank: Optional[int] = 768
    kv_lora_rank: int = 256
    qk_nope_dim: int = 64
    qk_rope_dim: int = 32
    v_head_dim: int = 64


def _qkv(params, x, cfg: AttnCfg, cos, sin, positions):
    b, s, _ = x.shape
    h, kvh, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    q = dense(params["wq"], x).reshape(b, s, h, hd)
    k = dense(params["wk"], x).reshape(b, s, kvh, hd)
    v = dense(params["wv"], x).reshape(b, s, kvh, hd)
    q = apply_rope(q, cos, sin, positions)
    k = apply_rope(k, cos, sin, positions)
    return q, k, v


def _scores_to_out(q, k, v, mask, scale):
    """q: (b,sq,kv,g,hd); k/v: (b,sk,kv,hd); mask: (b|1,sq,sk) bool."""
    logits = torch.einsum("bqkgd,bskd->bkgqs", q.to(torch.float32),
                          k.to(torch.float32)) * scale
    logits = torch.where(mask[:, None, None, :, :], logits, NEG_INF)
    probs = torch.softmax(logits, dim=-1)
    out = torch.einsum("bkgqs,bskd->bqkgd",
                       probs.to(v.dtype).to(torch.float32),
                       v.to(torch.float32))
    return out.to(v.dtype)


def _group(q, cfg: AttnCfg):
    b, s, h, hd = q.shape
    return q.reshape(b, s, cfg.n_kv_heads, h // cfg.n_kv_heads, hd)


def attend_full(q, k, v, cfg: AttnCfg, q_positions, k_positions):
    """Materialized causal (+ optional sliding-window) attention."""
    scale = cfg.head_dim ** -0.5
    qg = _group(q, cfg)
    delta = q_positions[:, :, None] - k_positions[:, None, :]
    mask = delta >= 0
    if cfg.window is not None:
        mask = mask & (delta < cfg.window)
    out = _scores_to_out(qg, k, v, mask, scale)
    b, s = q.shape[0], q.shape[1]
    return out.reshape(b, s, cfg.n_heads, v.shape[-1])


def attend_blockwise(q, k, v, cfg: AttnCfg, q_positions, k_positions):
    """Query chunks of ``q_chunk``; with a window each chunk reads a static
    KV band of ``cq + ceil(window/cq)·cq`` positions, left-padded with
    positions −1 (masked)."""
    b, s, h, hd = q.shape
    cq = min(cfg.q_chunk, s)
    if s % cq:
        raise ValueError(f"seq {s} not divisible by q_chunk {cq}")
    scale = hd ** -0.5
    qg = _group(q, cfg)
    outs = []
    if cfg.window is not None:
        band = cq + ((cfg.window + cq - 1) // cq) * cq
        pad = band - cq
        kp = F.pad(k, (0, 0, 0, 0, pad, 0))
        vp = F.pad(v, (0, 0, 0, 0, pad, 0))
        posp = F.pad(k_positions, (pad, 0), value=-1)
        for i in range(s // cq):
            qpos = q_positions[:, i * cq:(i + 1) * cq]
            kpos = posp[:, i * cq:i * cq + band]
            delta = qpos[:, :, None] - kpos[:, None, :]
            mask = ((delta >= 0) & (kpos[:, None, :] >= 0)
                    & (delta < cfg.window))
            outs.append(_scores_to_out(qg[:, i * cq:(i + 1) * cq],
                                       kp[:, i * cq:i * cq + band],
                                       vp[:, i * cq:i * cq + band], mask,
                                       scale))
    else:
        for i in range(s // cq):
            qpos = q_positions[:, i * cq:(i + 1) * cq]
            mask = qpos[:, :, None] >= k_positions[:, None, :]
            outs.append(_scores_to_out(qg[:, i * cq:(i + 1) * cq], k, v,
                                       mask, scale))
    return torch.cat(outs, dim=1).reshape(b, s, cfg.n_heads, v.shape[-1])


def _tp_heads(cfg: AttnCfg, tp) -> AttnCfg:
    """``cfg`` with this rank's heads under ``tp``."""
    return dataclasses.replace(cfg, n_heads=cfg.n_heads // tp.size,
                               n_kv_heads=cfg.n_kv_heads // tp.size)


def _out_proj(params, out, tp):
    """``wo`` on the heads' outputs; row-parallel under ``tp``."""
    if tp_active(tp):
        return row_dense(params["wo"], out, tp)
    return dense(params["wo"], out)


def _self_attention(params, x, cfg: AttnCfg, cos, sin, positions,
                    force_blockwise, tp):
    """The full-sequence attention: ``(y, k, v, positions, cfg)``, k/v
    and cfg this rank's heads under ``tp``."""
    b, s, _ = x.shape
    if positions is None:
        positions = torch.arange(s, device=x.device).expand(b, s)
    if tp_active(tp):
        x = copy_to_model(x, tp)
        cfg = _tp_heads(cfg, tp)
    q, k, v = _qkv(params, x, cfg, cos, sin, positions)
    blockwise = (s >= cfg.blockwise_threshold if force_blockwise is None
                 else force_blockwise)
    attend = attend_blockwise if blockwise else attend_full
    out = attend(q, k, v, cfg, positions, positions)
    return _out_proj(params, out.reshape(b, s, -1), tp), k, v, positions, cfg


def attention_apply(params, x, cfg: AttnCfg, cos, sin, positions=None,
                    force_blockwise: Optional[bool] = None, tp=None):
    """Self-attention of ``x`` (b, s, d) with params ``{"wq", "wk", "wv",
    "wo"}`` (each ``{"w"}``, q/k/v with ``"b"`` under ``qkv_bias``);
    under ``tp`` this rank's heads of each, the output summed over the
    worker's ranks."""
    return _self_attention(params, x, cfg, cos, sin, positions,
                           force_blockwise, tp)[0]


def _slots(cfg: AttnCfg, max_len: int) -> int:
    return max_len if cfg.window is None else min(cfg.window, max_len)


def _pad_slots(t, pad: int, value=0):
    """``t`` (b, s, ...) with ``pad`` slots appended along dim 1."""
    return F.pad(t, (0, 0) * (t.dim() - 2) + (0, pad), value=value)


def _prompt_cache(cfg: AttnCfg, k, v, positions, max_len: int) -> dict:
    """A prompt's K/V (b, s, kv, hd) in the decode cache's layout: the
    full cache holds positions 0 … s−1 at slots 0 … s−1 and −1 after
    them; the ring (a window) holds position p at slot ``p % slots``,
    which for a prompt tail longer than the ring is a roll by ``s mod
    slots``."""
    s = positions.shape[1]
    slots = _slots(cfg, max_len)
    positions = positions.to(torch.int32)
    if cfg.window is not None and s > slots:
        sh = s % slots

        def roll(t):
            return torch.roll(t[:, s - slots:], sh, dims=1)
        return {"k": roll(k), "v": roll(v), "pos": roll(positions)}
    if s > slots:
        raise ValueError(f"prompt of {s} positions past the cache's "
                         f"{slots} slots")
    pad = slots - s
    return {"k": _pad_slots(k, pad), "v": _pad_slots(v, pad),
            "pos": _pad_slots(positions, pad, value=-1)}


def attention_prefill(params, x, cfg: AttnCfg, cos, sin, max_len: int,
                      positions=None, tp=None):
    """The full-sequence attention of ``x`` (b, s, d) and its decode cache
    of ``max_len`` positions: ``(y, {"k", "v", "pos"})``; under ``tp``
    the cache of this rank's KV heads."""
    y, k, v, positions, cfg = _self_attention(params, x, cfg, cos, sin,
                                              positions, None, tp)
    return y, _prompt_cache(cfg, k, v, positions, max_len)


def init_kv_cache(cfg: AttnCfg, batch: int, max_len: int, dtype,
                  device=None) -> dict:
    """The empty cache: ``max_len`` slots, or a ring of ``min(window,
    max_len)`` with a window; K and V zero, every ``pos`` −1 (int32).
    ``cfg`` holds the heads the cache is for (a rank's under TP)."""
    slots = _slots(cfg, max_len)
    shape = (batch, slots, cfg.n_kv_heads, cfg.head_dim)
    return {"k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device),
            "pos": torch.full((batch, slots), -1, dtype=torch.int32,
                              device=device)}


def _decode_mask(cpos, pos: int, window: Optional[int]):
    """The slots that a query at ``pos`` reads: (b, 1, slots)."""
    mask = (cpos >= 0) & (cpos <= pos)
    if window is not None:
        mask = mask & (cpos > pos - window)
    return mask[:, None, :]


def attention_decode(params, x, cache: dict, pos, cfg: AttnCfg, cos, sin,
                     tp=None):
    """One new position ``pos`` (the same for the whole batch) of ``x``
    (b, 1, d) against ``cache``: ``(y, cache)``, the step's K, V and
    position written into the cache in place at slot ``pos`` (``pos %
    slots`` on a ring)."""
    b = x.shape[0]
    pos = int(pos)
    positions = torch.full((b, 1), pos, dtype=torch.long, device=x.device)
    if tp_active(tp):
        x = copy_to_model(x, tp)
        cfg = _tp_heads(cfg, tp)
    q, k_new, v_new = _qkv(params, x, cfg, cos, sin, positions)
    slots = cache["k"].shape[1]
    slot = pos % slots if cfg.window is not None else pos
    cache["k"][:, slot] = k_new[:, 0]
    cache["v"][:, slot] = v_new[:, 0]
    cache["pos"][:, slot] = pos
    mask = _decode_mask(cache["pos"], pos, cfg.window)
    out = _scores_to_out(_group(q, cfg), cache["k"], cache["v"], mask,
                         cfg.head_dim ** -0.5)
    return _out_proj(params, out.reshape(b, 1, -1), tp), cache


# ============================================================================ MLA
def _mla_qkv(params, x, cfg: AttnCfg, cos, sin, positions, tp=None):
    """The rotated query halves, the normed KV latent ``ckv`` (b, s, r) and
    the one rotary key head ``k_rope`` (b, s, 1, qk_rope_dim); under
    ``tp`` the latents' and the rotary head's gradients summed over the
    worker's ranks."""
    b, s, _ = x.shape
    if cfg.q_lora_rank:
        cq = copy_to_model(rmsnorm(params["q_norm"],
                                   dense(params["wdq"], x)), tp)
        q = dense(params["wuq"], cq)
    else:
        q = dense(params["wq"], copy_to_model(x, tp))
    q = q.reshape(b, s, cfg.n_heads, cfg.qk_nope_dim + cfg.qk_rope_dim)
    q_nope, q_rope = torch.split(q, [cfg.qk_nope_dim, cfg.qk_rope_dim],
                                 dim=-1)
    q_rope = apply_rope(q_rope, cos, sin, positions)
    ckv = copy_to_model(rmsnorm(params["kv_norm"],
                                dense(params["wdkv"], x)), tp)
    k_rope = copy_to_model(apply_rope(dense(params["wkr"], x).unsqueeze(2),
                                      cos, sin, positions), tp)
    return q_nope, q_rope, ckv, k_rope


def _mla_expand(params, ckv, k_rope, cfg: AttnCfg):
    """Per-head keys ``[k_nope, k_rope]`` and values from the latent; the
    rotary head is broadcast to all heads, so its gradient sums them."""
    b, s, _ = ckv.shape
    h = cfg.n_heads
    k_nope = dense(params["wuk"], ckv).reshape(b, s, h, cfg.qk_nope_dim)
    v = dense(params["wuv"], ckv).reshape(b, s, h, cfg.v_head_dim)
    k = torch.cat([k_nope, k_rope.expand(b, s, h, cfg.qk_rope_dim)], dim=-1)
    return k, v


def _mla_attention(params, x, cfg: AttnCfg, cos, sin, positions, tp):
    """The full-sequence MLA: ``(y, ckv, k_rope, positions)``."""
    b, s, _ = x.shape
    if positions is None:
        positions = torch.arange(s, device=x.device).expand(b, s)
    split = tp_active(tp)
    if split:
        cfg = dataclasses.replace(cfg, n_heads=cfg.n_heads // tp.size)
    q_nope, q_rope, ckv, k_rope = _mla_qkv(params, x, cfg, cos, sin,
                                           positions, tp if split else None)
    k, v = _mla_expand(params, ckv, k_rope, cfg)
    q = torch.cat([q_nope, q_rope], dim=-1)
    mcfg = _mha(cfg)
    attend = (attend_blockwise if s >= cfg.blockwise_threshold
              else attend_full)
    out = attend(q, k, v, mcfg, positions, positions)
    return (_out_proj(params, out.reshape(b, s, -1), tp), ckv, k_rope,
            positions)


def _mha(cfg: AttnCfg) -> AttnCfg:
    """MLA as MHA (n_kv == n_heads) over the nope + rope dims."""
    return dataclasses.replace(cfg, n_kv_heads=cfg.n_heads,
                               head_dim=cfg.qk_nope_dim + cfg.qk_rope_dim)


def mla_apply(params, x, cfg: AttnCfg, cos, sin, positions=None, tp=None):
    """Multi-head latent attention of ``x`` (b, s, d) with params ``{"wdq",
    "q_norm", "wuq", "wdkv", "kv_norm", "wkr", "wuk", "wuv", "wo"}`` (a
    direct query: ``"wq"`` in place of the first three); ``cos``/``sin``
    are tables of ``qk_rope_dim``.  Under ``tp`` this rank's heads of
    ``wuq``/``wuk``/``wuv``/``wo``, the output summed over the worker's
    ranks."""
    with span(ATTN_MLA):
        return _mla_attention(params, x, cfg, cos, sin, positions, tp)[0]


def mla_prefill(params, x, cfg: AttnCfg, cos, sin, max_len: int,
                positions=None, tp=None):
    """MLA over ``x`` (b, s, d) and its compressed cache of ``max_len``
    positions: ``(y, {"ckv", "krope", "pos"})``, the latents whole under
    ``tp``."""
    y, ckv, k_rope, positions = _mla_attention(params, x, cfg, cos, sin,
                                               positions, tp)
    pad = max_len - ckv.shape[1]
    if pad < 0:
        raise ValueError(f"prompt of {ckv.shape[1]} positions past the "
                         f"cache's {max_len}")
    return y, {"ckv": _pad_slots(ckv, pad), "krope": _pad_slots(k_rope, pad),
               "pos": _pad_slots(positions.to(torch.int32), pad, value=-1)}


def init_mla_cache(cfg: AttnCfg, batch: int, max_len: int, dtype,
                   device=None) -> dict:
    """The empty compressed cache: latent ``ckv`` and the shared rotary key
    ``krope`` zero, every ``pos`` −1 (int32)."""
    return {"ckv": torch.zeros((batch, max_len, cfg.kv_lora_rank),
                               dtype=dtype, device=device),
            "krope": torch.zeros((batch, max_len, 1, cfg.qk_rope_dim),
                                 dtype=dtype, device=device),
            "pos": torch.full((batch, max_len), -1, dtype=torch.int32,
                              device=device)}


def mla_decode(params, x, cache: dict, pos, cfg: AttnCfg, cos, sin,
               tp=None):
    """One new position ``pos`` of ``x`` (b, 1, d) against the compressed
    ``cache``, written into it in place: ``(y, cache)``.  Every slot's
    latent is expanded through ``wuk``/``wuv`` (this rank's heads under
    ``tp``) at every step."""
    b = x.shape[0]
    pos = int(pos)
    positions = torch.full((b, 1), pos, dtype=torch.long, device=x.device)
    split = tp_active(tp)
    if split:
        cfg = dataclasses.replace(cfg, n_heads=cfg.n_heads // tp.size)
    q_nope, q_rope, ckv_new, krope_new = _mla_qkv(
        params, x, cfg, cos, sin, positions, tp if split else None)
    cache["ckv"][:, pos] = ckv_new[:, 0]
    cache["krope"][:, pos] = krope_new[:, 0]
    cache["pos"][:, pos] = pos
    k, v = _mla_expand(params, cache["ckv"], cache["krope"], cfg)
    q = torch.cat([q_nope, q_rope], dim=-1)
    mcfg = _mha(cfg)
    out = _scores_to_out(_group(q, mcfg), k, v,
                         _decode_mask(cache["pos"], pos, None),
                         mcfg.head_dim ** -0.5)
    return _out_proj(params, out.reshape(b, 1, -1), tp), cache
