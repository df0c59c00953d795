"""Analytic FLOP / HBM-traffic model for the roofline terms.

Port of ``src/repro/launch/analytic.py``, the same arithmetic over the
port's ``ModelCfg``/``InputShape``: :func:`analytic_cost` gives the
reference's numbers for every arch × shape × kind.  The reference used it
because XLA's ``cost_analysis`` counts loop bodies once; the port's dry run
(:mod:`repro_torch.launch.dryrun`) uses it as the reference does, so the
two records' analytic fields compare exactly.

All numbers are *per call* (train_round = p steps + 1 gossip round;
prefill = one prompt batch; decode = one token per sequence).
"""
from __future__ import annotations

from typing import Dict

from repro_torch.configs.base import LayerSpec, ModelCfg
from repro_torch.configs.shapes import InputShape, torch_dtype

__all__ = ["analytic_cost"]


def _attn_flops_per_token(m: ModelCfg, s_eff: float) -> float:
    d, h, kv = m.d_model, m.n_heads, m.n_kv_heads
    hd = m.resolved_head_dim
    proj = 2 * d * hd * (h + 2 * kv) + 2 * h * hd * d
    core = 4 * h * hd * s_eff
    return proj + core


def _mla_flops_per_token(m: ModelCfg, s_eff: float) -> float:
    d, h = m.d_model, m.n_heads
    qk = m.qk_nope_dim + m.qk_rope_dim
    proj = 2 * (d * m.q_lora_rank + m.q_lora_rank * h * qk
                + d * m.kv_lora_rank + d * m.qk_rope_dim
                + m.kv_lora_rank * h * (m.qk_nope_dim + m.v_head_dim)
                + h * m.v_head_dim * d)
    core = 2 * h * qk * s_eff + 2 * h * m.v_head_dim * s_eff
    return proj + core


def _mamba_flops_per_token(m: ModelCfg, decode: bool) -> float:
    d = m.d_model
    di = m.ssm_expand * d
    h = di // m.ssm_headdim
    n, p, Q = m.ssm_state, m.ssm_headdim, m.ssm_chunk
    conv_dim = di + 2 * n
    ipd = di + conv_dim + h
    proj = 2 * d * ipd + 2 * di * d
    conv = 2 * 4 * conv_dim
    if decode:
        ssd = 2 * h * (2 * n * p + n)          # state update + readout
    else:
        # intra-chunk quadratic + chunk-state accumulate + inter readout
        ssd = 2 * h * (Q * n + Q * p + 4 * n * p)
    return proj + conv + ssd


def _ffn_flops_per_token(m: ModelCfg, spec: LayerSpec) -> float:
    mats = 3 if m.gated_mlp else 2
    f = 0.0
    if spec.ffn in ("dense", "dense+moe"):
        f += 2 * m.d_model * m.d_ff * mats
    if spec.ffn in ("moe", "dense+moe"):
        f += 2 * m.d_model * m.n_experts          # router
        f += m.top_k * 2 * m.d_model * m.d_ff * mats
    return f


def _fwd_flops_per_token(m: ModelCfg, s_eff: float, decode: bool) -> float:
    total = 2 * m.d_model * m.vocab               # lm head
    for spec in m.pattern:
        n = m.n_repeats
        if spec.mixer == "attn":
            f = _attn_flops_per_token(m, s_eff)
        elif spec.mixer == "mla":
            f = _mla_flops_per_token(m, s_eff)
        else:
            f = _mamba_flops_per_token(m, decode)
        total += n * (f + _ffn_flops_per_token(m, spec))
    return total


def _itemsize(name: str) -> int:
    """Bytes of a config dtype string (numpy has no bfloat16)."""
    return torch_dtype(name).itemsize


def _param_bytes(m: ModelCfg) -> float:
    return m.params_count() * _itemsize(m.param_dtype)


def _cache_bytes_per_seq(m: ModelCfg, s: int) -> float:
    """Decode-cache bytes per sequence (what one decode step must read)."""
    dt = _itemsize(m.compute_dtype)
    total = 0.0
    for spec in m.pattern:
        n = m.n_repeats
        if spec.mixer == "attn":
            slots = min(m.window, s) if m.window else s
            total += n * 2 * slots * m.n_kv_heads * m.resolved_head_dim * dt
        elif spec.mixer == "mla":
            total += n * s * (m.kv_lora_rank + m.qk_rope_dim) * dt
        else:
            di = m.ssm_expand * m.d_model
            h = di // m.ssm_headdim
            total += n * (h * m.ssm_state * m.ssm_headdim * 4
                          + 3 * (di + 2 * m.ssm_state) * dt)
    return total


def analytic_cost(m: ModelCfg, shape: InputShape, kind: str, p: int,
                  n_chips: int, n_workers: int,
                  remat: str) -> Dict[str, float]:
    """Per-device flops and HBM bytes for one compiled call."""
    s = shape.seq_len
    gb = shape.global_batch
    dt = _itemsize(m.compute_dtype)

    if kind == "decode":
        s_eff = float(min(m.window, s)) if m.window else float(s)
        tokens = gb                      # one token per sequence
    else:
        s_eff = min(s / 2.0, float(m.window)) if m.window else s / 2.0
        tokens = gb * s

    fwd = _fwd_flops_per_token(m, s_eff, kind == "decode")
    if kind == "train":
        mult = 3.0 + (1.0 if remat == "full" else 0.0)   # fwd+bwd (+remat fwd)
        flops_total = fwd * tokens * mult * p
    else:
        flops_total = fwd * tokens
    flops_dev = flops_total / n_chips

    # ---- HBM traffic (per device)
    pb_local = _param_bytes(m) * n_workers / n_chips   # replicated per worker
    tokens_dev = tokens / n_chips * (p if kind == "train" else 1)
    act_unit = m.n_layers * m.d_model * dt
    if kind == "train":
        # fwd+bwd activation RW (~16 streams/layer) + params fwd/bwd/opt
        act = tokens_dev * act_unit * 16
        # fwd/bwd reads + opt + gossip
        params_traffic = pb_local * (2 * p + 3 * p + 4)
        bytes_dev = act + params_traffic
    elif kind == "prefill":
        act = tokens_dev * act_unit * 6
        bytes_dev = act + pb_local
    else:
        cache = _cache_bytes_per_seq(m, s) * gb / n_chips
        bytes_dev = 2 * cache + pb_local + tokens_dev * act_unit * 6
    return {"flops_per_device": flops_dev,
            "flops_total": flops_total,
            "bytes_per_device": bytes_dev,
            "tokens": tokens * (p if kind == "train" else 1)}
