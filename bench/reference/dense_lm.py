"""A decoder-only transformer of attention and dense MLP layers (OLMo).

After OLMo (arXiv:2402.00838): token embedding; per layer a pre-norm
causal self-attention with rotary positions (the two halves of the head
dim rotated together, θ from the configuration) and a pre-norm MLP, each
added to the residual; a final norm and the output head; the mean
next-token cross entropy.  OLMo's norm is a LayerNorm without scale or
bias (eps 1e-5).  The MLP is SwiGLU, ``(silu(x·wg) ⊙ x·wi)·wo`` (or
``GELU(tanh form)(x·wi)·wo`` without a gate), and the head is the
embedding table, transposed (or a matrix of its own where the
configuration unties it).

Leaves are named as the program names them, each block leaf with a
leading repeat dim: ``embed.table``, ``blocks.pos0.attn.w{q,k,v,o}.w``,
``blocks.pos0.mlp.w{i,o}.w`` (and ``wg`` gated), ``lm_head.w`` (untied),
and the norm scales ``blocks.pos0.norm_{mix,ffn}.scale`` and
``final_norm.scale`` under an RMSNorm.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from bench.reference.common import (cross_entropy, gelu_tanh, head,
                                    layernorm_plain, normal_rule, rmsnorm,
                                    rope)


def _check(model: dict):
    if [p["mixer"] for p in model["pattern"]] != ["attn"] or \
            [p["ffn"] for p in model["pattern"]] != ["dense"]:
        raise ValueError("dense_lm: the pattern is one (attn, dense) layer")
    if model.get("qkv_bias") or model.get("window"):
        raise ValueError("dense_lm: no qkv bias or window")
    if model["norm"] not in ("nonparametric", "rmsnorm"):
        raise ValueError(f"dense_lm: norm {model['norm']!r}")


def _head_dim(model: dict) -> int:
    return model.get("head_dim") or model["d_model"] // model["n_heads"]


def param_shapes(model: dict) -> dict:
    """One worker's leaves and shapes, in the program's leaf order."""
    _check(model)
    d, f, v = model["d_model"], model["d_ff"], model["vocab"]
    r, hd = model["n_layers"], _head_dim(model)
    h, kv = model["n_heads"], model["n_kv_heads"]
    shapes = {"blocks.pos0.attn.wk.w": (r, d, kv * hd),
              "blocks.pos0.attn.wo.w": (r, h * hd, d),
              "blocks.pos0.attn.wq.w": (r, d, h * hd),
              "blocks.pos0.attn.wv.w": (r, d, kv * hd)}
    if model["gated_mlp"]:
        shapes["blocks.pos0.mlp.wg.w"] = (r, d, f)
    shapes["blocks.pos0.mlp.wi.w"] = (r, d, f)
    shapes["blocks.pos0.mlp.wo.w"] = (r, f, d)
    if model["norm"] == "rmsnorm":
        shapes["blocks.pos0.norm_ffn.scale"] = (r, d)
        shapes["blocks.pos0.norm_mix.scale"] = (r, d)
    shapes["embed.table"] = (v, d)
    if model["norm"] == "rmsnorm":
        shapes["final_norm.scale"] = (d,)
    if not model["tie_embeddings"]:
        shapes["lm_head.w"] = (d, v)
    return shapes


init_rule = normal_rule


def _norm(model, params, name, x, i=None):
    if model["norm"] == "nonparametric":
        return layernorm_plain(x)
    scale = params[name] if i is None else params[name][i]
    return rmsnorm(x, scale)


def _attention(q, k, v, ops):
    """Causal softmax attention; q (b, s, h, hd), k/v (b, s, kv, hd)."""
    b, s, h, hd = q.shape
    rep = h // k.shape[2]
    k = k.repeat_interleave(rep, dim=2)
    v = v.repeat_interleave(rep, dim=2)
    qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))      # (b, h, s, hd)
    scores = ops.mm(qt, kt.transpose(-1, -2)) * hd ** -0.5
    causal = torch.ones((s, s), dtype=torch.bool, device=q.device).tril()
    scores = scores.masked_fill(~causal, float("-inf"))
    out = ops.mm(torch.softmax(scores, dim=-1), vt)
    return out.transpose(1, 2).reshape(b, s, h * hd)


def loss(params: dict, batch: dict, model: dict, ops, mask=None):
    """Mean next-token cross entropy of one worker's ``batch`` (tokens and
    labels (b, s)); ``mask`` keeps a subset of the positions."""
    d, hd = model["d_model"], _head_dim(model)
    h, kv = model["n_heads"], model["n_kv_heads"]
    x = params["embed.table"][batch["tokens"].long()]
    b, s, _ = x.shape
    p = "blocks.pos0."
    for i in range(model["n_layers"]):
        a = _norm(model, params, p + "norm_mix.scale", x, i)
        q = ops.mm(a, params[p + "attn.wq.w"][i]).reshape(b, s, h, hd)
        k = ops.mm(a, params[p + "attn.wk.w"][i]).reshape(b, s, kv, hd)
        v = ops.mm(a, params[p + "attn.wv.w"][i]).reshape(b, s, kv, hd)
        q = rope(q, model["rope_theta"])
        k = rope(k, model["rope_theta"])
        x = x + ops.mm(_attention(q, k, v, ops), params[p + "attn.wo.w"][i])
        a = _norm(model, params, p + "norm_ffn.scale", x, i)
        u = ops.mm(a, params[p + "mlp.wi.w"][i])
        if model["gated_mlp"]:
            u = F.silu(ops.mm(a, params[p + "mlp.wg.w"][i])) * u
        else:
            u = gelu_tanh(u)
        x = x + ops.mm(u, params[p + "mlp.wo.w"][i])
    x = _norm(model, params, "final_norm.scale", x)
    return cross_entropy(ops.mm(x, head(params, model)), batch["labels"],
                         mask)
