"""DeepSeek-V2(-Lite): multi-head latent attention and fine-grained
experts with shared ones, a card's share of the experts held.

After DeepSeek-V2 (arXiv:2405.04434) and the model's public
``config.json``: token embedding; per layer a pre-norm MLA and a pre-norm
FFN, each added to the residual; a final RMSNorm, an untied head and the
mean next-token cross entropy plus every expert layer's load-balance loss.

* MLA with a direct query (no q latent): ``q = x·wq`` gives each head
  ``qk_nope_dim`` plain and ``qk_rope_dim`` rotary dims; the keys' and
  values' latent ``c = RMSNorm(x·wdkv)`` (``kv_lora_rank`` wide) gives
  each head ``k_nope = c·wuk`` and ``v = c·wuv``; one rotary key head
  ``x·wkr`` is shared by all heads.  Causal softmax over the
  ``qk_nope_dim + qk_rope_dim`` dims at scale ``(qk_nope_dim +
  qk_rope_dim)^-0.5``, then ``·wo``.
* The FFN is a SwiGLU ``(silu(x·wg) ⊙ x·wi)·wo`` of width ``d_ff`` in a
  ``dense`` layer; in a ``moe`` layer the router's softmax over all
  ``n_experts`` picks each token's top ``top_k`` (greedy), each picked
  expert (a SwiGLU of width ``moe_d_ff``) adds its output times its gate
  (renormalised over the top-k only where ``moe_norm_topk`` is true), and
  ``n_shared_experts`` shared experts, one SwiGLU of width
  ``n_shared_experts·moe_d_ff``, add theirs on every token.  The
  load-balance loss is ``w·E·Σ_e P_e·f_e`` (``P_e`` the mean gate, ``f_e``
  the share of the slots routed to e), the sequence-wise loss at one
  sequence a worker.

Departures from the published model, each also in the configuration's
``assumed``:

* RoPE is plain at θ (no YaRN): the cell trains at 2,048 positions,
  within the pretraining length; the rotary dims are rotated as two
  halves, a fixed permutation of DeepSeek's interleaved pairs;
* ``wdkv`` and ``wkr`` are the two parts of ``kv_a_proj_with_mqa``,
  ``wuk`` and ``wuv`` of ``kv_b_proj``;
* an expert takes at most C = ceil(top_k·N/n_experts·capacity_factor)
  slots (rounded up to 8, at least 8) of the N tokens of a worker's
  batch, the first C in token order; the rest add nothing (the published
  model sets no capacity);
* only the ``experts_held`` experts from ``first`` (0 here) are held: the
  slots routed elsewhere add nothing, as on a card that holds its share
  of a layer divided over several.  The router, its top-k, the capacity
  and the load-balance loss are the whole layer's.

Leaves are named as the program names them, each block leaf with a
leading repeat dim (the pattern repeated ``n_layers / len(pattern)``
times): ``blocks.posN.attn.{wq,wdkv,wkr,wuk,wuv,wo}.w`` and
``.attn.kv_norm.scale``; ``blocks.posN.mlp.{wg,wi,wo}.w`` (dense);
``blocks.posN.moe.router.w``, ``.moe.{wg,wi,wo}`` (held, d, f) / (held,
f, d) and ``.moe.shared.{wg,wi,wo}.w``; ``blocks.posN.norm_{mix,ffn}
.scale``, ``embed.table``, ``final_norm.scale``, ``lm_head.w``.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from bench.reference.common import cross_entropy, normal_rule, rmsnorm, rope


def _check(model: dict):
    for p in model["pattern"]:
        if p["mixer"] != "mla" or p["ffn"] not in ("dense", "moe"):
            raise ValueError(f"deepseek_v2_lm: layer {p} is not MLA with a "
                             "dense or expert FFN")
    if model.get("q_lora_rank"):
        raise ValueError("deepseek_v2_lm: MLA with a direct query only")
    if model["norm"] != "rmsnorm" or model["tie_embeddings"] or \
            not model["gated_mlp"]:
        raise ValueError("deepseek_v2_lm: RMSNorm, SwiGLU, untied head")


def _expert_width(model: dict) -> int:
    return model.get("moe_d_ff") or model["d_ff"]


def held(model: dict) -> int:
    """The routed experts held here."""
    h = model.get("experts_held")
    return model["n_experts"] if h is None else h


def capacity(n_tokens: int, model: dict) -> int:
    """The slots an expert takes of ``n_tokens`` tokens."""
    c = math.ceil(model["top_k"] * n_tokens / model["n_experts"]
                  * model["capacity_factor"])
    return max(8, -(-c // 8) * 8)


def param_shapes(model: dict) -> dict:
    """One worker's leaves and shapes, in the program's leaf order."""
    _check(model)
    d, v = model["d_model"], model["vocab"]
    r = model["n_layers"] // len(model["pattern"])
    h, r_kv = model["n_heads"], model["kv_lora_rank"]
    nope, rot, vd = (model["qk_nope_dim"], model["qk_rope_dim"],
                     model["v_head_dim"])
    shapes = {"embed.table": (v, d), "final_norm.scale": (d,),
              "lm_head.w": (d, v)}
    for i, p in enumerate(model["pattern"]):
        b = f"blocks.pos{i}."
        shapes.update({
            b + "attn.wq.w": (r, d, h * (nope + rot)),
            b + "attn.wdkv.w": (r, d, r_kv), b + "attn.kv_norm.scale": (r, r_kv),
            b + "attn.wkr.w": (r, d, rot), b + "attn.wuk.w": (r, r_kv, h * nope),
            b + "attn.wuv.w": (r, r_kv, h * vd), b + "attn.wo.w": (r, h * vd, d),
            b + "norm_mix.scale": (r, d), b + "norm_ffn.scale": (r, d)})
        if p["ffn"] == "dense":
            f = model["d_ff"]
            shapes.update({b + "mlp.wg.w": (r, d, f), b + "mlp.wi.w": (r, d, f),
                           b + "mlp.wo.w": (r, f, d)})
        else:
            f, H = _expert_width(model), held(model)
            shapes.update({b + "moe.router.w": (r, d, model["n_experts"]),
                           b + "moe.wg": (r, H, d, f), b + "moe.wi": (r, H, d, f),
                           b + "moe.wo": (r, H, f, d)})
            fs = model.get("n_shared_experts", 0) * f
            if fs:
                shapes.update({b + "moe.shared.wg.w": (r, d, fs),
                               b + "moe.shared.wi.w": (r, d, fs),
                               b + "moe.shared.wo.w": (r, fs, d)})
    return {n: shapes[n] for n in sorted(shapes, key=lambda n: n.split("."))}


init_rule = normal_rule


def swiglu(x, wg, wi, wo, ops):
    return ops.mm(F.silu(ops.mm(x, wg)) * ops.mm(x, wi), wo)


def mla(p: dict, x: torch.Tensor, model: dict, ops) -> torch.Tensor:
    """MLA of ``x`` (b, s, d) with one layer's leaves ``p`` (``wq``,
    ``wdkv``, ``kv_norm``, ``wkr``, ``wuk``, ``wuv``, ``wo``)."""
    b, s, _ = x.shape
    h = model["n_heads"]
    nope, rot, vd = (model["qk_nope_dim"], model["qk_rope_dim"],
                     model["v_head_dim"])
    theta = model["rope_theta"]
    q = ops.mm(x, p["wq"]).reshape(b, s, h, nope + rot)
    q = torch.cat([q[..., :nope], rope(q[..., nope:], theta)], dim=-1)
    c = rmsnorm(ops.mm(x, p["wdkv"]), p["kv_norm"])
    k_rot = rope(ops.mm(x, p["wkr"]).reshape(b, s, 1, rot), theta)
    k = torch.cat([ops.mm(c, p["wuk"]).reshape(b, s, h, nope),
                   k_rot.expand(b, s, h, rot)], dim=-1)
    v = ops.mm(c, p["wuv"]).reshape(b, s, h, vd)
    qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))     # (b, h, s, ·)
    scores = ops.mm(qt, kt.transpose(-1, -2)) * (nope + rot) ** -0.5
    causal = torch.ones((s, s), dtype=torch.bool, device=x.device).tril()
    scores = scores.masked_fill(~causal, float("-inf"))
    out = ops.mm(torch.softmax(scores, dim=-1), vt)
    return ops.mm(out.transpose(1, 2).reshape(b, s, h * vd), p["wo"])


def moe(p: dict, x: torch.Tensor, model: dict, ops, first: int = 0):
    """The expert layer on ``x`` (b, s, d) with one layer's leaves ``p``
    (``router``, ``wg``/``wi``/``wo`` of the held experts from ``first``,
    ``shared`` where there are shared experts): ``(y, aux)``, y the held
    experts' part plus the shared experts'."""
    b, s, d = x.shape
    n, k, E = b * s, model["top_k"], model["n_experts"]
    xf = x.reshape(n, d)
    gates = torch.softmax(ops.mm(xf, p["router"]), dim=-1)      # (n, E)
    top_w, top_e = torch.topk(gates, k, dim=-1)
    if model.get("moe_norm_topk", True):
        top_w = top_w / top_w.sum(-1, keepdim=True)
    C = capacity(n, model)
    y = torch.zeros((n, d), dtype=torch.float32, device=x.device)
    for j in range(held(model)):
        hit = top_e == first + j                                 # (n, k)
        tokens = torch.nonzero(hit.any(-1))[:C, 0]               # in order
        w = (top_w * hit).sum(-1)[tokens]
        out = swiglu(xf[tokens], p["wg"][j], p["wi"][j], p["wo"][j], ops)
        y = y.index_add(0, tokens, out * w[:, None])
    if "shared" in p:
        sh = p["shared"]
        y = y + swiglu(xf, sh["wg"], sh["wi"], sh["wo"], ops)
    f_e = F.one_hot(top_e, E).to(torch.float32).sum((0, 1)) / (n * k)
    aux = model["router_aux_weight"] * E * torch.sum(gates.mean(0) * f_e)
    return y.reshape(b, s, d), aux


def layer_params(params: dict, pos: int, rep: int) -> dict:
    """Pattern position ``pos``'s leaves at repeat ``rep``, nested as
    :func:`mla` and :func:`moe` take them (``attn``, ``mlp``, ``moe``)."""
    out: dict = {}
    head = f"blocks.pos{pos}."
    for name, t in params.items():
        if not name.startswith(head):
            continue
        parts = name[len(head):].split(".")
        if parts[-1] in ("w", "scale"):
            parts = parts[:-1]
        node = out
        for key in parts[:-1]:
            node = node.setdefault(key, {})
        node[parts[-1]] = t[rep]
    return out


def loss(params: dict, batch: dict, model: dict, ops, mask=None):
    """Mean next-token cross entropy of one worker's ``batch`` (tokens and
    labels (b, s)) plus the expert layers' load-balance losses; ``mask``
    keeps a subset of the positions in the cross entropy."""
    pattern = model["pattern"]
    x = params["embed.table"][batch["tokens"].long()]
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    for i in range(model["n_layers"]):
        pos, rep = i % len(pattern), i // len(pattern)
        lp = layer_params(params, pos, rep)
        x = x + mla(lp["attn"], rmsnorm(x, lp["norm_mix"]), model, ops)
        a = rmsnorm(x, lp["norm_ffn"])
        if pattern[pos]["ffn"] == "dense":
            m = lp["mlp"]
            x = x + swiglu(a, m["wg"], m["wi"], m["wo"], ops)
        else:
            y, layer_aux = moe(lp["moe"], a, model, ops)
            x, aux = x + y, aux + layer_aux
    x = rmsnorm(x, params["final_norm.scale"])
    return cross_entropy(ops.mm(x, params["lm_head.w"]), batch["labels"],
                         mask) + aux
