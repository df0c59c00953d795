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
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

__all__ = [
    "dense", "rmsnorm", "layernorm", "nonparametric_layernorm", "embed",
    "rope_freqs", "apply_rope", "mlp", "truncated_normal",
]


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
def embed(p: dict, tokens: torch.Tensor) -> torch.Tensor:
    """Rows of ``p["table"]`` at integer ``tokens``."""
    return F.embedding(tokens.long(), p["table"])


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
def mlp(p: dict, x: torch.Tensor) -> torch.Tensor:
    """Gated SiLU MLP when ``p`` has ``wg``, else GELU (tanh form)."""
    h = dense(p["wi"], x)
    if "wg" in p:
        h = F.silu(dense(p["wg"], x).to(torch.float32)).to(x.dtype) * h
    else:
        h = F.gelu(h.to(torch.float32), approximate="tanh").to(x.dtype)
    return dense(p["wo"], h)
