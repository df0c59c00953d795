"""Plain building blocks shared by the reference models.

``Ops`` carries the precision of the matrix products: ``"f32"`` (TF32
off, the configurations' stated precision) or ``"tf32"`` (the control:
the step below f32 that would tempt a later change).  On a card TF32 is
the hardware's, switched on for the reference's products; on the CPU it
is emulated by rounding both operands of every product, forward and
backward, to TF32's 10-bit mantissa.
"""
from __future__ import annotations

import contextlib
import math

import torch
import torch.nn.functional as F


def round_tf32(t: torch.Tensor) -> torch.Tensor:
    """``t`` (f32) rounded to the nearest TF32 value, ties to even."""
    bits = t.contiguous().view(torch.int32)
    bias = 0xFFF + ((bits >> 13) & 1)
    return ((bits + bias) & ~0x1FFF).view(torch.float32)


class _TF32MatMul(torch.autograd.Function):
    @staticmethod
    def forward(ctx, a, b):
        ctx.save_for_backward(a, b)
        return torch.matmul(round_tf32(a), round_tf32(b))

    @staticmethod
    def backward(ctx, g):
        a, b = ctx.saved_tensors
        g = round_tf32(g)
        ga = torch.matmul(g, round_tf32(b).transpose(-1, -2))
        gb = torch.matmul(round_tf32(a).transpose(-1, -2), g)
        return (ga.sum_to_size(a.shape), gb.sum_to_size(b.shape))


class Ops:
    """The reference's matrix product in one precision."""

    def __init__(self, precision: str = "f32"):
        if precision not in ("f32", "tf32"):
            raise ValueError(f"precision {precision!r}")
        self.precision = precision

    def mm(self, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        if self.precision == "tf32" and a.device.type != "cuda":
            return _TF32MatMul.apply(a, b)
        return torch.matmul(a, b)

    @contextlib.contextmanager
    def active(self):
        """Within: the card's TF32 switches as this precision wants."""
        cuda = torch.backends.cuda.matmul
        before = (cuda.allow_tf32, torch.backends.cudnn.allow_tf32)
        on = self.precision == "tf32"
        cuda.allow_tf32 = torch.backends.cudnn.allow_tf32 = on
        try:
            yield self
        finally:
            cuda.allow_tf32, torch.backends.cudnn.allow_tf32 = before


def layernorm_plain(x: torch.Tensor, eps: float = 1e-5) -> torch.Tensor:
    """LayerNorm without scale or bias (OLMo's), biased variance."""
    mean = x.mean(-1, keepdim=True)
    var = ((x - mean) ** 2).mean(-1, keepdim=True)
    return (x - mean) / torch.sqrt(var + eps)


def rmsnorm(x: torch.Tensor, scale: torch.Tensor,
            eps: float = 1e-6) -> torch.Tensor:
    return x / torch.sqrt((x * x).mean(-1, keepdim=True) + eps) * scale


def gelu_tanh(x: torch.Tensor) -> torch.Tensor:
    c = math.sqrt(2.0 / math.pi)
    return 0.5 * x * (1.0 + torch.tanh(c * (x + 0.044715 * x ** 3)))


def rope(x: torch.Tensor, theta: float) -> torch.Tensor:
    """Rotary embedding of ``x`` (b, s, heads, hd) at positions 0..s−1,
    the two halves of the head dim rotated together."""
    s, hd = x.shape[1], x.shape[-1]
    inv = theta ** (-torch.arange(0, hd, 2, dtype=torch.float32,
                                  device=x.device) / hd)
    ang = torch.arange(s, dtype=torch.float32, device=x.device)[:, None] * inv
    cos, sin = torch.cos(ang)[:, None, :], torch.sin(ang)[:, None, :]
    x1, x2 = x[..., :hd // 2], x[..., hd // 2:]
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)


def cross_entropy(logits: torch.Tensor, labels: torch.Tensor,
                  mask=None) -> torch.Tensor:
    """Mean next-token cross entropy over the positions ``mask`` keeps
    (every position without one)."""
    nll = F.cross_entropy(logits.reshape(-1, logits.shape[-1]),
                          labels.reshape(-1).long(), reduction="none")
    if mask is None:
        return nll.mean()
    m = mask.reshape(-1).to(nll.dtype)
    return (nll * m).sum() / m.sum()


def head(params: dict, model: dict) -> torch.Tensor:
    """The output head ``(d_model, vocab)``: the embedding table,
    transposed, where the configuration ties the two."""
    if model["tie_embeddings"]:
        return params["embed.table"].T
    return params["lm_head.w"]


def normal_rule(name: str, shape: tuple):
    """The init of a leaf without a rule of its own: a normal of std
    ``fan_in ** -0.5`` for a weight matrix, ``d_model ** -0.5`` for an
    embedding table (0.022 at 2,048, near the published models' 0.02; as
    a tied head it gives logits of about unit spread), 1 for a norm
    scale."""
    leaf = name.rsplit(".", 1)[-1]
    if leaf == "scale":
        return ("const", 1.0)
    if leaf == "table":
        return ("normal", shape[-1] ** -0.5)
    return ("normal", shape[-2] ** -0.5)
