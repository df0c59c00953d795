"""A Mamba-2 language model: SSD mixers only (Mamba2-1.3B).

After Mamba-2 (arXiv:2405.21060): token embedding; per layer a pre-norm
(RMSNorm) SSD mixer added to the residual; a final RMSNorm and the output
head; the mean next-token cross entropy.  The mixer: ``in_proj`` gives
z, xBC and dt; xBC through a depthwise causal conv of ``conv_kernel``
taps and SiLU, then split into x (heads × headdim), B and C (one group,
``d_state`` each); ``dt = softplus(dt + dt_bias)``, ``A = −exp(A_log)``;
the scan ``S_t = exp(dt_t·A)·S_{t−1} + dt_t·B_t ⊗ x_t``, ``y_t = C_t·S_t
+ D·x_t``; the gated RMSNorm ``rmsnorm(y·silu(z))`` and ``out_proj``.

The SSD here is its quadratic (attention-like) form over the whole
sequence, not the program's chunked one: ``y = (L ∘ C·Bᵀ ∘ dt) x`` with
``L[q, j] = exp(Σ_{j<t≤q} dt_t·A)`` for ``j ≤ q``, each segment sum taken
as a cumulative sum that starts at its own j (the paper's ``segsum``), so
no difference of two long sums loses digits.  The head is the embedding
table, transposed, as Mamba2-1.3B ties it (or a matrix of its own where
the configuration unties it).
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from bench.reference.common import cross_entropy, head, normal_rule, rmsnorm


def dims(model: dict) -> dict:
    d_inner = model["ssm_expand"] * model["d_model"]
    heads = d_inner // model["ssm_headdim"]
    conv = d_inner + 2 * model["ssm_state"]
    return {"d_inner": d_inner, "heads": heads, "conv_dim": conv,
            "in_proj": d_inner + conv + heads, "conv_kernel": 4}


def _check(model: dict):
    if [(p["mixer"], p["ffn"]) for p in model["pattern"]] != \
            [("mamba", "none")]:
        raise ValueError("mamba2_lm: the pattern is one (mamba, none) layer")
    if model["norm"] != "rmsnorm":
        raise ValueError("mamba2_lm: RMSNorm only")


def param_shapes(model: dict) -> dict:
    """One worker's leaves and shapes, in the program's leaf order."""
    _check(model)
    d, v, r = model["d_model"], model["vocab"], model["n_layers"]
    s = dims(model)
    p = "blocks.pos0.mamba."
    shapes = {p + "A_log": (r, s["heads"]), p + "D": (r, s["heads"]),
            p + "conv_b": (r, s["conv_dim"]),
            p + "conv_w": (r, s["conv_kernel"], s["conv_dim"]),
            p + "dt_bias": (r, s["heads"]),
            p + "in_proj.w": (r, d, s["in_proj"]),
            p + "norm.scale": (r, s["d_inner"]),
            p + "out_proj.w": (r, s["d_inner"], d),
            "blocks.pos0.norm_mix.scale": (r, d),
            "embed.table": (v, d), "final_norm.scale": (d,)}
    if not model["tie_embeddings"]:
        shapes["lm_head.w"] = (d, v)
    return shapes


def init_rule(name: str, shape: tuple):
    """Mamba-2's init of the SSM leaves (A from 1 to 16 over the heads, dt
    from 0.001 to 0.1 log-spaced through ``dt_bias = softplus⁻¹(dt)``, D
    one, the conv's taps small), else :func:`normal_rule`."""
    leaf = name.rsplit(".", 1)[-1]
    if leaf == "A_log":
        a = torch.linspace(1.0, 16.0, shape[-1], dtype=torch.float32)
        return ("values", torch.log(a).expand(shape))
    if leaf == "dt_bias":
        dt = torch.exp(torch.linspace(math.log(1e-3), math.log(0.1),
                                      shape[-1], dtype=torch.float32))
        return ("values", (dt + torch.log(-torch.expm1(-dt))).expand(shape))
    if leaf == "D":
        return ("const", 1.0)
    if leaf == "conv_b":
        return ("const", 0.0)
    if leaf == "conv_w":
        return ("normal", 0.1)
    return normal_rule(name, shape)


def _segsum(dA: torch.Tensor) -> torch.Tensor:
    """(b, h, s) → (b, h, s, s): ``Σ_{j<t≤q} dA_t`` at [q, j] for j ≤ q,
    −inf above the diagonal."""
    s = dA.shape[-1]
    rep = dA[..., :, None].expand(*dA.shape, s)            # [q, j] = dA_q
    strict = torch.ones((s, s), dtype=torch.bool, device=dA.device).tril(-1)
    seg = torch.cumsum(rep.masked_fill(~strict, 0.0), dim=-2)
    keep = torch.ones((s, s), dtype=torch.bool, device=dA.device).tril()
    return seg.masked_fill(~keep, float("-inf"))


def _mixer(params: dict, i: int, u: torch.Tensor, model: dict, ops):
    s_ = dims(model)
    p = "blocks.pos0.mamba."
    b, s, _ = u.shape
    di, heads, hd, n = (s_["d_inner"], s_["heads"], model["ssm_headdim"],
                        model["ssm_state"])
    zxbcdt = ops.mm(u, params[p + "in_proj.w"][i])
    z, xbc, dt = torch.split(zxbcdt, [di, s_["conv_dim"], heads], dim=-1)
    w = params[p + "conv_w"][i]                              # (k, conv)
    k = w.shape[0]
    xbc = F.conv1d(xbc.transpose(1, 2), w.t()[:, None, :],
                   params[p + "conv_b"][i], padding=k - 1,
                   groups=xbc.shape[-1])[..., :s].transpose(1, 2)
    xbc = F.silu(xbc)
    x, B, C = torch.split(xbc, [di, n, n], dim=-1)
    x = x.reshape(b, s, heads, hd)
    dt = F.softplus(dt + params[p + "dt_bias"][i])            # (b, s, h)
    A = -torch.exp(params[p + "A_log"][i])                    # (h,)
    L = torch.exp(_segsum((dt * A).transpose(1, 2)))          # (b, h, s, s)
    cb = ops.mm(C, B.transpose(1, 2))                         # (b, s, s)
    m = L * cb[:, None] * dt.transpose(1, 2)[:, :, None, :]
    y = ops.mm(m, x.transpose(1, 2)).transpose(1, 2)         # (b, s, h, hd)
    y = y + params[p + "D"][i][:, None] * x
    g = y.reshape(b, s, di) * F.silu(z)
    return ops.mm(rmsnorm(g, params[p + "norm.scale"][i]),
                  params[p + "out_proj.w"][i])


def loss(params: dict, batch: dict, model: dict, ops, mask=None):
    """Mean next-token cross entropy of one worker's ``batch`` (tokens and
    labels (b, s)); ``mask`` keeps a subset of the positions."""
    x = params["embed.table"][batch["tokens"].long()]
    for i in range(model["n_layers"]):
        h = rmsnorm(x, params["blocks.pos0.norm_mix.scale"][i])
        x = x + _mixer(params, i, h, model, ops)
    x = rmsnorm(x, params["final_norm.scale"])
    return cross_entropy(ops.mm(x, head(params, model)), batch["labels"],
                         mask)
