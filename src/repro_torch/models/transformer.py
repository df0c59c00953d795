"""Decoder-only transformer: the unified model of every LM config.

Port of ``src/repro/models/transformer.py:38-232`` and ``make_model``
(``:431``).  A model is a repeating block pattern (``ModelCfg.pattern``)
of ``LayerSpec(mixer, ffn)`` layers, repeated ``n_repeats`` times with
params stacked over the repeats.  The mixer is ``attn`` (GQA),
``mla`` (:func:`repro_torch.models.attention.mla_apply`, its params under
``attn`` as the reference names them; RoPE then spans ``qk_rope_dim``)
or ``mamba`` (:mod:`repro_torch.models.mamba2`, params under ``mamba``);
the FFN ``dense``, ``moe`` (:mod:`repro_torch.models.moe`), ``dense+moe``
(their sum) or none, so Jamba's hybrid pattern (mamba/attn × dense/moe)
is the same per-position loop.  The inputs are ``tokens``, ``embeds``
(audio: precomputed frame embeddings, ``batch["embeds"]``) or ``vlm``
(precomputed ``patch_embeds`` before the token embeddings; the loss pads
the labels with −1 over the image prefix).  Still to come:

* the serving methods (KV and SSM caches, prefill, decode; reference
  ``:234-429``) — ROADMAP queue A item 13;
* ``remat`` and the sharding hints (``shd``) — item 12.

Params are a flat dict named by the reference's key paths
(``embed.table``, ``blocks.pos0.attn.wq.w`` with a leading ``n_repeats``
dim, ``final_norm.scale``, ``lm_head.w``; a non-parametric norm has no
leaf; an MoE FFN adds ``blocks.posN.moe.{router.w, wg, wi, wo}``, a
Mamba mixer ``blocks.posN.mamba.{A_log, D, conv_b, conv_w, dt_bias,
in_proj.w, norm.scale, out_proj.w}``).
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
from repro_torch.models import mamba2 as mamba_lib
from repro_torch.models import moe as moe_lib
from repro_torch.models.attention import AttnCfg
from repro_torch.models.layers import (embed, layernorm, mlp,
                                       nonparametric_layernorm, rmsnorm,
                                       rope_freqs, truncated_normal)
from repro_torch.tree import leaf_order

__all__ = ["Model", "make_model"]


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
    """One pattern position: ``norm_mix``, the mixer (``attn`` for GQA and
    MLA, ``mamba``), and unless the FFN is ``none`` ``norm_ffn`` with
    ``mlp`` and/or ``moe``, stacked over the repeats."""

    def __init__(self, cfg: ModelCfg, a: AttnCfg, s: mamba_lib.Mamba2Cfg,
                 m: moe_lib.MoECfg, spec: LayerSpec, device=None):
        super().__init__()
        if spec.mixer not in ("attn", "mla", "mamba"):
            raise ValueError(spec.mixer)
        if spec.ffn not in ("dense", "moe", "dense+moe", "none"):
            raise ValueError(spec.ffn)
        self.cfg, self.attn_cfg, self.mamba_cfg = cfg, a, s
        self.moe_cfg, self.spec = m, spec
        lead = (cfg.n_repeats,)
        d = cfg.d_model
        self.norm_mix = _norm(cfg, lead, device)
        if spec.mixer == "attn":
            self.attn = nn.Module()
            h, kvh, hd = a.n_heads, a.n_kv_heads, a.head_dim
            self.attn.wq = _dense(d, h * hd, lead, device, a.qkv_bias)
            self.attn.wk = _dense(d, kvh * hd, lead, device, a.qkv_bias)
            self.attn.wv = _dense(d, kvh * hd, lead, device, a.qkv_bias)
            self.attn.wo = _dense(h * hd, d, lead, device)
        elif spec.mixer == "mla":
            self.attn = nn.Module()
            h, qk = a.n_heads, a.qk_nope_dim + a.qk_rope_dim
            self.attn.wdq = _dense(d, a.q_lora_rank, lead, device)
            self.attn.q_norm = _Params({"scale": (a.q_lora_rank,)}, lead,
                                       device)
            self.attn.wuq = _dense(a.q_lora_rank, h * qk, lead, device)
            self.attn.wdkv = _dense(d, a.kv_lora_rank, lead, device)
            self.attn.kv_norm = _Params({"scale": (a.kv_lora_rank,)}, lead,
                                        device)
            self.attn.wkr = _dense(d, a.qk_rope_dim, lead, device)
            self.attn.wuk = _dense(a.kv_lora_rank, h * a.qk_nope_dim, lead,
                                   device)
            self.attn.wuv = _dense(a.kv_lora_rank, h * a.v_head_dim, lead,
                                   device)
            self.attn.wo = _dense(h * a.v_head_dim, d, lead, device)
        else:
            self.mamba = _Params({"conv_w": (s.conv_kernel, s.conv_dim),
                                  "conv_b": (s.conv_dim,),
                                  "A_log": (s.n_heads,),
                                  "dt_bias": (s.n_heads,),
                                  "D": (s.n_heads,)}, lead, device)
            self.mamba.in_proj = _dense(d, s.in_proj_dim, lead, device)
            self.mamba.norm = _Params({"scale": (s.d_inner,)}, lead, device)
            self.mamba.out_proj = _dense(s.d_inner, d, lead, device)
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
        if self.spec.mixer == "attn":
            mix = attn_lib.attention_apply(lp["attn"], h, self.attn_cfg,
                                           cos, sin, positions)
        elif self.spec.mixer == "mla":
            mix = attn_lib.mla_apply(lp["attn"], h, self.attn_cfg, cos, sin,
                                     positions)
        else:
            mix = mamba_lib.mamba2_apply(lp["mamba"], h, self.mamba_cfg)
        x = x + mix
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

    def __init__(self, cfg: ModelCfg, a: AttnCfg, s: mamba_lib.Mamba2Cfg,
                 m: moe_lib.MoECfg, compute_dtype: torch.dtype, device=None):
        super().__init__()
        if cfg.input_mode not in ("tokens", "embeds", "vlm"):
            raise ValueError(cfg.input_mode)
        self.cfg, self.attn_cfg, self.compute_dtype = cfg, a, compute_dtype
        self.embed = _Params({"table": (cfg.vocab, cfg.d_model)}, (), device)
        self.blocks = nn.Module()
        for pos, spec in enumerate(cfg.pattern):
            self.blocks.add_module(f"pos{pos}",
                                   _Layer(cfg, a, s, m, spec, device))
        self.final_norm = _norm(cfg, (), device)
        if not cfg.tie_embeddings:
            self.lm_head = _dense(cfg.d_model, cfg.vocab, (), device)

    def _embed_inputs(self, batch):
        """The first layer's input (reference ``_embed_inputs``): token
        embeddings, the given frame embeddings, or the patch embeddings
        followed by the token embeddings, in the compute dtype."""
        cd, mode = self.compute_dtype, self.cfg.input_mode
        if mode == "embeds":
            return batch["embeds"].to(cd)
        x = embed(_tree(self.embed), batch["tokens"]).to(cd)
        if mode == "vlm":
            x = torch.cat([batch["patch_embeds"].to(cd), x], dim=1)
        return x

    def forward(self, batch):
        cfg = self.cfg
        x = self._embed_inputs(batch)
        b, s, _ = x.shape
        cos, sin = rope_freqs(cfg.qk_rope_dim if cfg.use_mla
                              else self.attn_cfg.head_dim, s, cfg.rope_theta,
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
        self.mamba_cfg = mamba_lib.Mamba2Cfg(
            d_model=cfg.d_model, d_state=cfg.ssm_state,
            headdim=cfg.ssm_headdim, expand=cfg.ssm_expand,
            chunk=cfg.ssm_chunk)
        self.net = _Net(cfg, self.attn_cfg, self.mamba_cfg, self.moe_cfg,
                        self.compute_dtype, device="meta")

    # ------------------------------------------------------------------ init
    def param_shapes(self) -> dict:
        """``{name: shape}`` of one worker's params, in leaf order."""
        shapes = {n: tuple(t.shape) for n, t in self.net.named_parameters()}
        return {n: shapes[n] for n in leaf_order(shapes)}

    def leaf_dtype(self, name: str) -> torch.dtype:
        """The dtype :meth:`init` gives leaf ``name``: ``param_dtype``, but
        f32 for the MoE router and the SSM's ``A_log``, ``dt_bias``, ``D``."""
        leaf = name.rsplit(".", 1)[-1]
        ssm = name.rsplit(".", 2)[-2] == "mamba"
        if name.endswith(".moe.router.w") or (
                ssm and leaf in ("A_log", "dt_bias", "D")):
            return torch.float32
        return self.param_dtype

    def init(self, generator: torch.Generator, device="cuda") -> dict:
        """Fresh params drawn from ``generator`` on its own device, in leaf
        order, and moved to ``device``: dense weights a truncated normal
        times ``in_dim ** -0.5`` (the experts' ``wi``/``wg`` (E, d, f) at
        d^-0.5, ``wo`` (E, f, d) at f^-0.5: ``shape[-2]`` in each case),
        the embedding times 1.0, norm scales 1 and biases 0, in
        ``param_dtype``; the MoE router in f32 whatever ``param_dtype``
        is, as the reference's ``moe_init`` draws it.  The Mamba leaves
        follow the reference's ``mamba2_init``: ``conv_w`` a normal (not
        truncated) times 0.1 and ``conv_b`` zeros in ``param_dtype``;
        ``A_log = log(linspace(1, 16, heads))``, ``dt_bias`` zeros and
        ``D`` ones, these three in f32 whatever ``param_dtype`` is."""
        device = resolve_device(device)
        gdev = generator.device
        f32 = torch.float32
        params = {}
        for name, shape in self.param_shapes().items():
            leaf = name.rsplit(".", 1)[-1]
            ssm = name.rsplit(".", 2)[-2] == "mamba"
            dtype = self.leaf_dtype(name)
            if ssm and leaf == "conv_w":
                t = (torch.randn(shape, generator=generator, device=gdev,
                                 dtype=f32) * 0.1).to(dtype)
            elif ssm and leaf == "A_log":
                t = torch.log(torch.linspace(1.0, 16.0, shape[-1],
                                             dtype=f32)).expand(shape).clone()
            elif leaf == "scale" or (ssm and leaf == "D"):
                t = torch.ones(shape, dtype=dtype)
            elif leaf in ("bias", "b") or (ssm and leaf in ("conv_b",
                                                             "dt_bias")):
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
        over ``max(#labels, 1)``: ``(ce + aux, {"ce", "aux"})``.  Under the
        ``vlm`` input mode the labels cover the text positions only: they
        are padded with −1 over the image prefix."""
        logits, aux = self.apply(params, batch)
        labels = batch["labels"].long()
        if self.cfg.input_mode == "vlm":
            labels = F.pad(labels, (logits.shape[-2] - labels.shape[-1], 0),
                           value=-1)
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
