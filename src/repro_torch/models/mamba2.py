"""Mamba-2 SSD (state-space duality) mixer — arXiv:2405.21060.

Port of the training half of ``src/repro/models/mamba2.py:27-186``, the
reference's formula step by step in plain PyTorch (the reference has no
Pallas kernel here).  ``in_proj`` gives ``z``, ``xBC`` and ``dt``; ``xBC``
goes through a depthwise causal conv (the sum of ``conv_kernel`` shifted
products, plus ``conv_b``, then SiLU in f32); ``dt = softplus(dt +
dt_bias)``, ``A = −exp(A_log)``.  The chunked SSD then computes, for each
head, the scan ``S ← S·exp(dt·A) + dt·B⊗x``, ``y = C·S + D·x``:

* within a chunk of ``chunk`` positions, a quadratic form with the decay
  mask ``L[q, j] = exp(cum_q − cum_j)`` for ``j ≤ q`` (``cum`` the cumsum
  of ``dt·A``); the upper triangle is set to −1e9 **before** the ``exp``,
  so that no overflowed ``exp`` meets a zero in the gradient;
* each chunk's state ``Σ_j exp(cum_end − cum_j)·dt_j·B_j ⊗ x_j``;
* across chunks a Python loop over the chunks (the reference's
  ``lax.scan``), which emits the state entering each chunk;
* the gated RMSNorm ``rmsnorm(y·silu(z))`` and ``out_proj``.

Every contraction takes two operands, in the reference's left-to-right
order (``torch.einsum`` would reorder three or more where ``opt_einsum``
is installed, and left to right it never builds a 6-D intermediate).  The
groups' B and C are broadcast to the heads (the reference's
``bcast_groups`` and ``jnp.repeat`` lowerings give the same values, so
the port has the one, and ``ModelCfg.ssm_bcast_groups`` does not reach
it).  Nothing is written in place and nothing is read on the host, so the
mixer runs under ``torch.func.vmap`` over the workers.

``F.softplus`` returns its input above ``threshold=20``, where
``jax.nn.softplus`` computes ``log1p(exp(−x)) + x``: the two agree to f32
rounding there.

Under tensor parallelism (``tp``, a
:class:`~repro_torch.models.layers.TPGroup` of the worker's ranks;
:mod:`repro_torch.launch.sharding` splits the leaves by component) each
rank runs its ``n_heads/tp`` heads: its columns of z, x and dt in
``in_proj``, its x channels of the conv, its slices of ``A_log``,
``dt_bias``, ``D`` and the norm's scale, and its rows of ``out_proj``
(row-parallel, the partial products summed).  B and C (one group) stay
whole on every rank but feed only its heads, so their gradient is summed
over the ranks once, after the conv (:func:`copy_to_model`); ``u`` reaches
the split columns through ``copy_to_model`` and B and C's columns as it
is, so its gradient is summed once on each path.  The gated RMSNorm
normalizes over the whole ``d_inner``: its sum of squares is summed over
the ranks, and so is that sum's gradient, since every rank's slice reads
it (:func:`sum_over_model`).

Serving (reference ``:176-230``): ``mamba2_apply(return_state=True)``
also returns the decode cache, the final SSM state ``S`` (b, heads,
d_state, headdim) in f32 and the last ``conv_kernel − 1`` raw conv inputs
(left-padded with zeros when the sequence is shorter);
:func:`init_mamba_cache` is that cache empty (``ssm`` f32 whatever the
compute dtype); :func:`mamba2_decode` is the O(1) step: the rolling conv
over the cached inputs and the new one, ``dA = exp(dt·A)``, ``S ← S·dA +
dt·B⊗x``, ``y = C·S + D·x``, then the gated norm and ``out_proj``; it
writes the new state and conv window into the cache in place and returns
it.  Under ``tp`` the cache follows the head split above: the rank's heads
of ``S``, and the conv inputs of its x channels beside B's and C's whole
(the reference's GSPMD layout cuts ``conv_dim`` contiguously instead,
which changes no value).
"""
from __future__ import annotations

import dataclasses

import torch
import torch.nn.functional as F

from repro_torch.models.layers import (copy_to_model, dense, rmsnorm,
                                       row_dense, sum_over_model, tp_active)

__all__ = ["Mamba2Cfg", "mamba2_apply", "mamba2_decode", "init_mamba_cache"]


@dataclasses.dataclass(frozen=True)
class Mamba2Cfg:
    d_model: int
    d_state: int = 128
    headdim: int = 64
    expand: int = 2
    chunk: int = 256
    conv_kernel: int = 4
    n_groups: int = 1

    @property
    def d_inner(self) -> int:
        return self.expand * self.d_model

    @property
    def n_heads(self) -> int:
        return self.d_inner // self.headdim

    @property
    def conv_dim(self) -> int:
        return self.d_inner + 2 * self.n_groups * self.d_state

    @property
    def in_proj_dim(self) -> int:
        # z, xBC, dt
        return self.d_inner + self.conv_dim + self.n_heads


def _split_zxbcdt(cfg: Mamba2Cfg, zxbcdt):
    return torch.split(zxbcdt, [cfg.d_inner, cfg.conv_dim, cfg.n_heads],
                       dim=-1)


def _causal_conv(xBC, w, b):
    """Depthwise causal conv1d.  xBC: (b, s, c); w: (k, c)."""
    k, s = w.shape[0], xBC.shape[1]
    pad = F.pad(xBC, (0, 0, k - 1, 0))
    out = pad[:, 0:s] * w[0]
    for i in range(1, k):
        out = out + pad[:, i:i + s] * w[i]
    return F.silu((out + b).to(torch.float32)).to(xBC.dtype)


def _split_xbc(cfg: Mamba2Cfg, xBC, bsz: int, s: int, tp=None):
    """x (b, s, heads, headdim) and B, C broadcast to the heads; under
    ``tp`` this rank's heads, B's and C's gradients summed over the
    worker's ranks."""
    gn = cfg.n_groups * cfg.d_state
    heads = cfg.n_heads // (tp.size if tp_active(tp) else 1)
    x, B, C = torch.split(xBC, [heads * cfg.headdim, gn, gn], dim=-1)
    B, C = copy_to_model(B, tp), copy_to_model(C, tp)
    x = x.reshape(bsz, s, heads, cfg.headdim)
    rep = heads // cfg.n_groups

    def to_heads(t):          # group g serves heads g·rep … g·rep + rep − 1
        t = t.reshape(bsz, s, cfg.n_groups, 1, cfg.d_state)
        return t.expand(bsz, s, cfg.n_groups, rep, cfg.d_state).reshape(
            bsz, s, heads, cfg.d_state)
    return x, to_heads(B), to_heads(C)


def _in_proj(params, u, cfg: Mamba2Cfg, tp):
    """z, xBC and dt from ``in_proj``; under ``tp`` (this rank's columns
    ``[z, x, B, C, dt]``) the split columns read ``copy_to_model(u)`` and
    B's and C's read ``u``."""
    if not tp_active(tp):
        return _split_zxbcdt(cfg, dense(params["in_proj"], u))
    w = params["in_proj"]["w"]
    di = cfg.d_inner // tp.size
    bc = 2 * cfg.n_groups * cfg.d_state
    uc = copy_to_model(u, tp)
    z, x = torch.split(dense({"w": w[..., :2 * di]}, uc), [di, di], dim=-1)
    BC = dense({"w": w[..., 2 * di:2 * di + bc]}, u)
    dt = dense({"w": w[..., 2 * di + bc:]}, uc)
    return z, torch.cat([x, BC], dim=-1), dt


def _gated_norm(params, y, z, cfg: Mamba2Cfg, dtype, tp):
    """``rmsnorm(y·silu(z))`` over the whole ``d_inner``; under ``tp`` the
    sum of squares of this rank's slice summed over the worker's ranks."""
    f32 = torch.float32
    g = (y.to(f32) * F.silu(z.to(f32))).to(dtype)
    if not tp_active(tp):
        return rmsnorm(params["norm"], g)
    g32 = g.to(f32)
    var = sum_over_model(torch.sum(g32 * g32, dim=-1, keepdim=True),
                         tp) / cfg.d_inner
    return (g32 * torch.rsqrt(var + 1e-6)
            * params["norm"]["scale"].to(f32)).to(dtype)


def mamba2_apply(params, u, cfg: Mamba2Cfg, return_state: bool = False,
                 tp=None):
    """u: (b, s, d_model) → (b, s, d_model), by the chunked SSD.  Params
    ``{"in_proj", "conv_w", "conv_b", "A_log", "dt_bias", "D", "norm",
    "out_proj"}`` (under ``tp`` this rank's heads of them); ``s`` a
    multiple of ``min(chunk, s)``.  With ``return_state`` also the decode
    cache ``{"ssm", "conv"}`` after the last position."""
    bsz, s, _ = u.shape
    Q = min(cfg.chunk, s)
    if s % Q:
        raise ValueError(f"seq {s} % chunk {Q} != 0")
    nc = s // Q
    split = tp_active(tp)
    h = cfg.n_heads // (tp.size if split else 1)
    p, n = cfg.headdim, cfg.d_state
    f32 = torch.float32

    z, xBC_raw, dt_raw = _in_proj(params, u, cfg, tp)
    xBC = _causal_conv(xBC_raw, params["conv_w"], params["conv_b"])
    x, B, C = _split_xbc(cfg, xBC, bsz, s, tp)

    dt = F.softplus(dt_raw.to(f32) + params["dt_bias"])         # (b,s,h)
    A = -torch.exp(params["A_log"])                             # (h,)
    dA = dt * A                                                 # ≤ 0

    # chunked views
    xc = x.reshape(bsz, nc, Q, h, p).to(f32)
    Bc = B.reshape(bsz, nc, Q, h, n).to(f32)
    Cc = C.reshape(bsz, nc, Q, h, n).to(f32)
    dtc = dt.reshape(bsz, nc, Q, h)
    cum = torch.cumsum(dA.reshape(bsz, nc, Q, h), dim=2)        # (b,nc,Q,h)

    # intra-chunk: L[q, j] = exp(cum_q − cum_j) for j ≤ q, masked before exp
    rel = cum[:, :, :, None, :] - cum[:, :, None, :, :]         # (b,nc,Q,Q,h)
    causal = torch.ones((Q, Q), dtype=torch.bool, device=u.device).tril()
    L = torch.exp(torch.where(causal[:, :, None], rel, -1e9))
    att = torch.einsum("bcqhn,bcjhn->bcqjh", Cc, Bc) * L
    y_intra = torch.einsum("bcqjh,bcjhp->bcqhp", att * dtc[:, :, None],
                           xc)

    # chunk states: S_c = Σ_j exp(cum_end − cum_j) dt_j B_j ⊗ x_j
    decay_to_end = torch.exp(cum[:, :, -1:, :] - cum)           # (b,nc,Q,h)
    states = torch.einsum("bcjhn,bcjhp->bchnp",
                          (decay_to_end * dtc)[..., None] * Bc, xc)
    chunk_decay = torch.exp(cum[:, :, -1, :])                   # (b,nc,h)

    # inter-chunk recurrence, emitting the state entering each chunk
    S = torch.zeros_like(states[:, 0])
    entering = []
    for c in range(nc):
        entering.append(S)
        S = S * chunk_decay[:, c, :, None, None] + states[:, c]
    S_in = torch.stack(entering, dim=1)                         # (b,nc,h,n,p)

    # inter-chunk output: y_q += exp(cum_q) C_q · S_in
    y_inter = torch.einsum("bcqhn,bchnp->bcqhp",
                           torch.exp(cum)[..., None] * Cc, S_in)

    y = (y_intra + y_inter).reshape(bsz, s, h, p)
    y = y + params["D"][:, None] * x.to(f32)
    y = y.reshape(bsz, s, h * p).to(u.dtype)

    # gated RMSNorm, then the output projection
    out = _out_proj(params, _gated_norm(params, y, z, cfg, u.dtype, tp), tp)
    if not return_state:
        return out
    # the decode cache: the final state and the last k − 1 raw conv inputs
    kk = cfg.conv_kernel - 1
    tail = (xBC_raw[:, s - kk:] if s >= kk
            else F.pad(xBC_raw, (0, 0, kk - s, 0)))
    return out, {"ssm": S, "conv": tail}


def _out_proj(params, y, tp):
    if tp_active(tp):
        return row_dense(params["out_proj"], y, tp)
    return dense(params["out_proj"], y)


def init_mamba_cache(cfg: Mamba2Cfg, batch: int, dtype, device=None,
                     tp=None) -> dict:
    """The empty decode cache: ``ssm`` (b, heads, d_state, headdim) f32
    and ``conv`` (b, conv_kernel − 1, conv channels) in ``dtype``; under
    ``tp`` this rank's heads and channels."""
    heads = cfg.n_heads // (tp.size if tp_active(tp) else 1)
    channels = heads * cfg.headdim + 2 * cfg.n_groups * cfg.d_state
    return {"ssm": torch.zeros((batch, heads, cfg.d_state, cfg.headdim),
                               dtype=torch.float32, device=device),
            "conv": torch.zeros((batch, cfg.conv_kernel - 1, channels),
                                dtype=dtype, device=device)}


def mamba2_decode(params, u, cache: dict, cfg: Mamba2Cfg, tp=None):
    """One position of ``u`` (b, 1, d_model) from ``cache``: ``(y,
    cache)``, the new state and conv window written into the cache in
    place."""
    f32 = torch.float32
    bsz = u.shape[0]
    z, xBC_new, dt_raw = _in_proj(params, u, cfg, tp)
    # the rolling conv over the cached inputs and the new one
    conv_in = torch.cat([cache["conv"], xBC_new], dim=1)        # (b, k, c)
    out = torch.einsum("bkc,kc->bc", conv_in.to(f32),
                       params["conv_w"].to(f32)) + params["conv_b"].to(f32)
    xBC = F.silu(out)[:, None, :].to(u.dtype)
    cache["conv"].copy_(conv_in[:, 1:])
    x, B, C = _split_xbc(cfg, xBC, bsz, 1, tp)
    dt = F.softplus(dt_raw.to(f32) + params["dt_bias"])[:, 0]   # (b, h)
    dA = torch.exp(dt * -torch.exp(params["A_log"]))
    x0, B0, C0 = x[:, 0].to(f32), B[:, 0].to(f32), C[:, 0].to(f32)
    S = cache["ssm"] * dA[:, :, None, None] + (
        dt[:, :, None, None] * B0[..., None]) * x0[:, :, None, :]
    cache["ssm"].copy_(S)
    y = torch.einsum("bhn,bhnp->bhp", C0, S)
    y = y + params["D"][:, None] * x0
    h = x0.shape[1]
    y = y.reshape(bsz, 1, h * cfg.headdim).to(u.dtype)
    y = _gated_norm(params, y, z, cfg, u.dtype, tp)
    return _out_proj(params, y, tp), cache
