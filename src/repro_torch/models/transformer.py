"""Decoder-only transformer: the dense path of the unified model.

Port of ``src/repro/models/transformer.py:38-232`` and ``make_model``
(``:431``).  A model is a repeating block pattern (``ModelCfg.pattern``)
of ``LayerSpec(mixer, ffn)`` layers, repeated ``n_repeats`` times with
params stacked over the repeats.  This slice runs the ``attn`` mixer with
a ``dense``, ``moe`` (:mod:`repro_torch.models.moe`), ``dense+moe`` (their
sum) or no FFN on token inputs; the other branches raise:

* the ``mla`` mixer (``use_mla``) — ROADMAP queue A item 11 step 3;
* the ``mamba`` mixer — item 11 step 4;
* the ``embeds`` and ``vlm`` input modes — item 11 step 5;
* the serving methods (KV caches, prefill, decode; reference
  ``:234-429``) — item 13;
* ``remat`` and the sharding hints (``shd``) — item 12.

Params are a flat dict named by the reference's key paths
(``embed.table``, ``blocks.pos0.attn.wq.w`` with a leading ``n_repeats``
dim, ``final_norm.scale``, ``lm_head.w``; a non-parametric norm has no
leaf; an MoE FFN adds ``blocks.posN.moe.{router.w, wg, wi, wo}``).
:class:`_Net` registers exactly those names on the meta device and
:meth:`Model.apply` runs it through ``torch.func.functional_call``, so one
function serves one worker and, under ``torch.func.vmap``, K stacked
workers.  The repeats are a Python loop over the stack's index (the
reference's ``lax.scan``), with no in-place op; the MoE layers' aux
losses are summed over the pattern and then over the repeats, as the
reference's scan carries them.
"""
from __future__ import annotations

from typing import Dict, Optional

import torch
import torch.nn.functional as F
from torch import nn

from repro_torch import resolve_device
from repro_torch.configs.base import LayerSpec, ModelCfg
from repro_torch.configs.shapes import torch_dtype
from repro_torch.models import attention as attn_lib
from repro_torch.models import moe as moe_lib
from repro_torch.models.attention import AttnCfg
from repro_torch.models.layers import (embed, layernorm, mlp,
                                       nonparametric_layernorm, rmsnorm,
                                       rope_freqs, truncated_normal)
from repro_torch.tree import leaf_order

__all__ = ["Model", "make_model"]

# the steps of ROADMAP queue A item 11 (and item 13) that port what this
# slice refuses
_LATER = {"mla": "item 11 step 3 (MLA)",
          "mamba": "item 11 step 4 (the SSM and hybrid blocks)",
          "embeds": "item 11 step 5 (the audio and VLM input modes)",
          "vlm": "item 11 step 5 (the audio and VLM input modes)"}


def _refuse(cfg: ModelCfg, what: str):
    raise NotImplementedError(f"{cfg.name}: {what!r} is not ported yet "
                              f"(ROADMAP queue A {_LATER[what]})")


class _Params(nn.Module):
    """The params of one reference dict (``{"w", "b"}``, ``{"scale"}``,
    ``{"table"}``), each with the leading dims ``lead``."""

    def __init__(self, shapes: dict, lead: tuple = (), device=None):
        super().__init__()
        for name, shape in shapes.items():
            self.register_parameter(name, nn.Parameter(
                torch.empty(lead + tuple(shape), device=device)))


def _tree(module: nn.Module, i: Optional[int] = None) -> dict:
    """``module``'s params as the reference's nested dict, every leaf at
    repeat ``i`` of its stack (whole when None)."""
    out: Dict = {n: (t if i is None else t[i])
                 for n, t in module.named_parameters(recurse=False)}
    for n, child in module.named_children():
        out[n] = _tree(child, i)
    return out


def _norm(cfg: ModelCfg, lead: tuple, device) -> _Params:
    if cfg.norm == "rmsnorm":
        return _Params({"scale": (cfg.d_model,)}, lead, device)
    if cfg.norm == "layernorm":
        return _Params({"scale": (cfg.d_model,), "bias": (cfg.d_model,)},
                       lead, device)
    if cfg.norm == "nonparametric":
        return _Params({}, lead, device)
    raise ValueError(cfg.norm)


def _norm_apply(cfg: ModelCfg):
    if cfg.norm == "rmsnorm":
        return rmsnorm
    if cfg.norm == "layernorm":
        return layernorm
    if cfg.norm == "nonparametric":
        return lambda p, x: nonparametric_layernorm(x)
    raise ValueError(cfg.norm)


def _dense(d_in: int, d_out: int, lead: tuple, device,
           bias: bool = False) -> _Params:
    shapes = {"w": (d_in, d_out)}
    if bias:
        shapes["b"] = (d_out,)
    return _Params(shapes, lead, device)


class _Layer(nn.Module):
    """One pattern position: ``norm_mix``, ``attn``, and unless the FFN is
    ``none`` ``norm_ffn`` with ``mlp`` and/or ``moe``, stacked over the
    repeats."""

    def __init__(self, cfg: ModelCfg, a: AttnCfg, m: moe_lib.MoECfg,
                 spec: LayerSpec, device=None):
        super().__init__()
        if spec.mixer != "attn":
            _refuse(cfg, spec.mixer)
        if spec.ffn not in ("dense", "moe", "dense+moe", "none"):
            raise ValueError(spec.ffn)
        self.cfg, self.attn_cfg, self.moe_cfg, self.spec = cfg, a, m, spec
        lead = (cfg.n_repeats,)
        self.norm_mix = _norm(cfg, lead, device)
        self.attn = nn.Module()
        h, kvh, hd, d = a.n_heads, a.n_kv_heads, a.head_dim, a.d_model
        self.attn.wq = _dense(d, h * hd, lead, device, a.qkv_bias)
        self.attn.wk = _dense(d, kvh * hd, lead, device, a.qkv_bias)
        self.attn.wv = _dense(d, kvh * hd, lead, device, a.qkv_bias)
        self.attn.wo = _dense(h * hd, d, lead, device)
        if spec.ffn != "none":
            self.norm_ffn = _norm(cfg, lead, device)
        if spec.ffn in ("dense", "dense+moe"):
            self.mlp = nn.Module()
            self.mlp.wi = _dense(d, cfg.d_ff, lead, device)
            self.mlp.wo = _dense(cfg.d_ff, d, lead, device)
            if cfg.gated_mlp:
                self.mlp.wg = _dense(d, cfg.d_ff, lead, device)
        if spec.ffn in ("moe", "dense+moe"):
            E, f = m.n_experts, m.d_ff
            shapes = {"wi": (E, d, f), "wo": (E, f, d)}
            if m.gated:
                shapes["wg"] = (E, d, f)
            self.moe = _Params(shapes, lead, device)
            self.moe.router = _dense(d, E, lead, device)

    def forward(self, x, i: int, cos, sin, positions):
        """Repeat ``i`` of this position (reference ``_apply_layer``):
        ``(x, aux)``, aux zero without an MoE FFN."""
        nap = _norm_apply(self.cfg)
        lp = _tree(self, i)
        h = nap(lp["norm_mix"], x)
        x = x + attn_lib.attention_apply(lp["attn"], h, self.attn_cfg,
                                         cos, sin, positions)
        aux = torch.zeros((), dtype=torch.float32, device=x.device)
        if self.spec.ffn == "none":
            return x, aux
        h = nap(lp["norm_ffn"], x)
        if self.spec.ffn == "dense":
            return x + mlp(lp["mlp"], h), aux
        out, aux = moe_lib.moe_apply(lp["moe"], h, self.moe_cfg)
        if self.spec.ffn == "dense+moe":
            out = mlp(lp["mlp"], h) + out
        return x + out, aux


class _Net(nn.Module):
    """The parameter tree of a :class:`Model` and its forward pass:
    ``batch`` → ``(logits f32, aux)``."""

    def __init__(self, cfg: ModelCfg, a: AttnCfg, m: moe_lib.MoECfg,
                 compute_dtype: torch.dtype, device=None):
        super().__init__()
        if cfg.input_mode != "tokens":
            _refuse(cfg, cfg.input_mode)
        if cfg.use_mla:
            _refuse(cfg, "mla")
        self.cfg, self.attn_cfg, self.compute_dtype = cfg, a, compute_dtype
        self.embed = _Params({"table": (cfg.vocab, cfg.d_model)}, (), device)
        self.blocks = nn.Module()
        for pos, spec in enumerate(cfg.pattern):
            self.blocks.add_module(f"pos{pos}",
                                   _Layer(cfg, a, m, spec, device))
        self.final_norm = _norm(cfg, (), device)
        if not cfg.tie_embeddings:
            self.lm_head = _dense(cfg.d_model, cfg.vocab, (), device)

    def forward(self, batch):
        cfg = self.cfg
        x = embed(_tree(self.embed), batch["tokens"]).to(self.compute_dtype)
        b, s, _ = x.shape
        cos, sin = rope_freqs(self.attn_cfg.head_dim, s, cfg.rope_theta,
                              device=x.device)
        positions = torch.arange(s, device=x.device).expand(b, s)
        aux = torch.zeros((), dtype=torch.float32, device=x.device)
        for i in range(cfg.n_repeats):
            block_aux = torch.zeros((), dtype=torch.float32, device=x.device)
            for pos in range(len(cfg.pattern)):
                x, a = getattr(self.blocks, f"pos{pos}")(x, i, cos, sin,
                                                         positions)
                block_aux = block_aux + a
            aux = aux + block_aux
        x = _norm_apply(cfg)(_tree(self.final_norm), x)
        head = (self.embed.table.T if cfg.tie_embeddings
                else self.lm_head.w)
        logits = torch.matmul(x.to(torch.float32), head.to(torch.float32))
        return logits, aux


class Model:
    """Functional model: ``init``, ``apply`` (logits) and ``loss`` over a
    flat param dict."""

    def __init__(self, cfg: ModelCfg):
        self.cfg = cfg
        self.param_dtype = torch_dtype(cfg.param_dtype)
        self.compute_dtype = torch_dtype(cfg.compute_dtype)
        self.attn_cfg = AttnCfg(
            d_model=cfg.d_model, n_heads=cfg.n_heads,
            n_kv_heads=cfg.n_kv_heads, head_dim=cfg.resolved_head_dim,
            qkv_bias=cfg.qkv_bias, window=cfg.window,
            rope_theta=cfg.rope_theta,
            q_lora_rank=cfg.q_lora_rank, kv_lora_rank=cfg.kv_lora_rank,
            qk_nope_dim=cfg.qk_nope_dim, qk_rope_dim=cfg.qk_rope_dim,
            v_head_dim=cfg.v_head_dim)
        self.moe_cfg = moe_lib.MoECfg(
            d_model=cfg.d_model, d_ff=cfg.d_ff, n_experts=cfg.n_experts,
            top_k=cfg.top_k, capacity_factor=cfg.capacity_factor,
            router_aux_weight=cfg.router_aux_weight, gated=cfg.gated_mlp,
            n_groups=cfg.moe_groups)
        self.net = _Net(cfg, self.attn_cfg, self.moe_cfg, self.compute_dtype,
                        device="meta")

    # ------------------------------------------------------------------ init
    def param_shapes(self) -> dict:
        """``{name: shape}`` of one worker's params, in leaf order."""
        shapes = {n: tuple(t.shape) for n, t in self.net.named_parameters()}
        return {n: shapes[n] for n in leaf_order(shapes)}

    def init(self, generator: torch.Generator, device="cuda") -> dict:
        """Fresh params drawn from ``generator`` on its own device, in leaf
        order, and moved to ``device``: dense weights a truncated normal
        times ``in_dim ** -0.5`` (the experts' ``wi``/``wg`` (E, d, f) at
        d^-0.5, ``wo`` (E, f, d) at f^-0.5: ``shape[-2]`` in each case),
        the embedding times 1.0, norm scales 1 and biases 0, in
        ``param_dtype``; the MoE router in f32 whatever ``param_dtype``
        is, as the reference's ``moe_init`` draws it."""
        device = resolve_device(device)
        params = {}
        for name, shape in self.param_shapes().items():
            leaf = name.rsplit(".", 1)[-1]
            dtype = (torch.float32 if name.endswith(".moe.router.w")
                     else self.param_dtype)
            if leaf == "scale":
                t = torch.ones(shape, dtype=dtype)
            elif leaf in ("bias", "b"):
                t = torch.zeros(shape, dtype=dtype)
            else:
                scale = 1.0 if leaf == "table" else shape[-2] ** -0.5
                t = truncated_normal(shape, dtype, scale, generator)
            params[name] = t.to(device)
        return params

    # ----------------------------------------------------------------- forward
    def apply(self, params: dict, batch: dict):
        """Full-sequence forward.  Returns ``(logits f32, aux_loss)``."""
        return torch.func.functional_call(self.net, params, (batch,))

    def loss(self, params: dict, batch: dict):
        """Next-token cross entropy over ``labels`` (−1 = masked), the mean
        over ``max(#labels, 1)``: ``(ce + aux, {"ce", "aux"})``."""
        logits, aux = self.apply(params, batch)
        labels = batch["labels"].long()
        mask = (labels >= 0).to(torch.float32)
        logp = F.log_softmax(logits, dim=-1)
        nll = -logp.gather(-1, labels.clamp_min(0)[..., None])[..., 0]
        ce = torch.sum(nll * mask) / torch.sum(mask).clamp_min(1.0)
        return ce + aux, {"ce": ce, "aux": aux}

    # ----------------------------------------------------------------- serving
    def _serving(self, *args, **kwargs):
        raise NotImplementedError(
            "serving (KV caches, prefill, decode) is ROADMAP queue A item 13")

    init_cache = prefill = prefill_fast = decode_step = _serving


def make_model(cfg: ModelCfg) -> Model:
    return Model(cfg)
