"""Plain PyTorch versions of the port's kernels.

The wrappers run these on CPU tensors; the tests hold them against the JAX
oracles in ``repro.kernels.ref`` and ``chip_smoke.py`` holds each CUDA
kernel against them on the card.  Each elementwise op is its own PyTorch
call, so every product and sum is rounded separately — the CUDA kernels
pin the same rounding with ``__fmul_rn``/``__fadd_rn`` and are bit-exact
against these.  Python float scalars (μ, wd, weights) are rounded to f32
by PyTorch, as the kernels' launch arguments are.
"""
from __future__ import annotations

__all__ = ["momentum_update_ref", "gossip_mix_ref"]


def momentum_update_ref(x, m, g, lr, *, mu, wd=0.0, nesterov=False):
    """``g' = g + wd·x; m' = μ·m + g'; x' = x − lr·d`` with ``d = m'``
    (Nesterov: ``g' + μ·m'``).  Returns ``(x', m')``."""
    g = g + wd * x
    m_new = mu * m + g
    d = (g + mu * m_new) if nesterov else m_new
    return x - lr * d, m_new


def gossip_mix_ref(tensors, weights):
    """``y = w₀·x₀ + w₁·x₁ + …`` accumulated left to right.  Starts from
    ``w₀·x₀`` as the Pallas kernel body does (the JAX oracle adds it to a
    zero, which differs only in the sign of a zero result)."""
    acc = weights[0] * tensors[0]
    for w, t in zip(weights[1:], tensors[1:]):
        acc = acc + w * t
    return acc
