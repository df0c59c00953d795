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
the labels with −1 over the image prefix).

``remat="full"`` (the reference's ``jax.checkpoint`` of each repeat,
``:198-205``) wraps each repeat's pass over the block pattern in
``torch.utils.checkpoint.checkpoint(..., use_reentrant=False)``: the
backward recomputes that pass instead of keeping its activations.  It
runs under plain autograd (the sharded runtime's gradient); under
``torch.func`` it raises, since those transforms do not support the
saved-tensor hooks the checkpoint is built on.

Under tensor parallelism (``make_model(cfg, tp=...)``, a
:class:`~repro_torch.models.layers.TPGroup` of the worker's ranks on the
model axis) the model holds this rank's shards of the leaves that
:func:`repro_torch.launch.sharding.shard_plan` splits: the embedding and
head over the vocab (a masked lookup, and the vocab-parallel cross
entropy), GQA and MLA by heads, the SSD mixer by heads (its B and C
whole), the MLP and the MoE experts by ``d_ff``.  Under FSDP
(``fsdp=...``, profile B's data axis) each leaf the plan splits over the
data axis is all-gathered where it is used (the blocks' leaves inside
each repeat's pass, so ``remat="full"`` frees the gathered copy after the
forward and gathers it again in the recomputation), and its gradient is
summed over the data ranks and cut back to the rank's slice
(:func:`~repro_torch.models.layers.gather_from_data`).  ``init`` draws
the whole leaves and keeps this rank's slices, so x₀ is the one-rank
model's.  ``loss(..., inner=group)`` is this rank's share of the loss of
a worker whose batch is split over ``group``: the cross entropy's
numerator over the worker's label count, the MoE's aux share; the
ranks' shares sum to the worker's loss and gradient.  The sharding
hints (``shd``) change no value and are not needed
(``launch/sharding.py``).
Serving (reference ``:234-429``): :meth:`Model.init_cache`,
:meth:`Model.prefill_fast` (one pass over the prompt, the cache packed per
layer and stacked over the repeats), :meth:`Model.decode_step` (one token,
or one frame embedding, for the batch; the cache written in place) and
:meth:`Model.prefill` (the prompt through the decode step, position by
position).  They are methods of the same modules (:class:`_Layer`'s
``prefill``/``decode`` beside ``forward``, sharing its FFN half; the
MoE runs on the step's b tokens, its capacity theirs), called through
``functional_call`` under ``torch.no_grad``; under TP a rank's cache holds
its heads and the logits are gathered whole over the vocab; under FSDP
each repeat's leaves are gathered inside its pass, as in training.

Params are a flat dict named by the reference's key paths
(``embed.table``, ``blocks.pos0.attn.wq.w`` with a leading ``n_repeats``
dim, ``final_norm.scale``, ``lm_head.w``; a non-parametric norm has no
leaf; an MoE FFN adds ``blocks.posN.moe.{router.w, wg, wi, wo}``, the
experts stacked over the ``experts_held`` it holds, and with shared
experts ``blocks.posN.moe.shared.{wg, wi, wo}.w``; a
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
import torch.distributed as dist
import torch.utils.checkpoint
import torch.nn.functional as F
from torch import nn

from repro_torch import resolve_device, spans
from repro_torch.configs.base import LayerSpec, ModelCfg
from repro_torch.configs.shapes import torch_dtype
from repro_torch.models import attention as attn_lib
from repro_torch.models import mamba2 as mamba_lib
from repro_torch.models import moe as moe_lib
from repro_torch.models.attention import AttnCfg
from repro_torch.models.layers import (copy_to_model, embed,
                                       gather_from_data, layernorm, mlp,
                                       nonparametric_layernorm, rmsnorm,
                                       rope_freqs, tp_active,
                                       truncated_normal, vocab_parallel_nll)
from repro_torch.tree import leaf_order

REMAT = ("none", "full")

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
                 m: moe_lib.MoECfg, spec: LayerSpec, device=None,
                 tp: Optional[dict] = None):
        super().__init__()
        # the TP group each module runs split over (None: replicated)
        self.tp = tp or {}
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
            if a.q_lora_rank:
                self.attn.wdq = _dense(d, a.q_lora_rank, lead, device)
                self.attn.q_norm = _Params({"scale": (a.q_lora_rank,)},
                                           lead, device)
                self.attn.wuq = _dense(a.q_lora_rank, h * qk, lead, device)
            else:
                self.attn.wq = _dense(d, h * qk, lead, device)
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
            H, f = m.n_held, m.d_ff
            shapes = {"wi": (H, d, f), "wo": (H, f, d)}
            if m.gated:
                shapes["wg"] = (H, d, f)
            self.moe = _Params(shapes, lead, device)
            self.moe.router = _dense(d, m.n_experts, lead, device)
            if m.n_shared:
                fs = m.n_shared * f
                self.moe.shared = nn.Module()
                self.moe.shared.wi = _dense(d, fs, lead, device)
                self.moe.shared.wo = _dense(fs, d, lead, device)
                if m.gated:
                    self.moe.shared.wg = _dense(d, fs, lead, device)

    def forward(self, lp: dict, x, cos, sin, positions, inner=None):
        """This position with params ``lp`` (one repeat's, ``_tree(self,
        i)``, gathered; reference ``_apply_layer``): ``(x, aux)``, aux zero
        without an MoE FFN; ``inner`` the group that splits the worker's
        batch (the MoE's)."""
        tp = self.tp
        h = _norm_apply(self.cfg)(lp["norm_mix"], x)
        if self.spec.mixer == "attn":
            mix = attn_lib.attention_apply(lp["attn"], h, self.attn_cfg,
                                           cos, sin, positions,
                                           tp=tp.get("attn"))
        elif self.spec.mixer == "mla":
            mix = attn_lib.mla_apply(lp["attn"], h, self.attn_cfg, cos, sin,
                                     positions, tp=tp.get("mla"))
        else:
            mix = mamba_lib.mamba2_apply(lp["mamba"], h, self.mamba_cfg,
                                         tp=tp.get("mamba"))
        return self._ffn(lp, x + mix, inner)

    def _ffn(self, lp: dict, x, inner=None):
        """The FFN half after the mixer's residual: ``(x, aux)``."""
        tp = self.tp
        aux = torch.zeros((), dtype=torch.float32, device=x.device)
        if self.spec.ffn == "none":
            return x, aux
        h = _norm_apply(self.cfg)(lp["norm_ffn"], x)
        if self.spec.ffn == "dense":
            return x + mlp(lp["mlp"], h, tp.get("mlp")), aux
        out, aux = moe_lib.moe_apply(lp["moe"], h, self.moe_cfg,
                                     tp.get("moe"), inner)
        if self.spec.ffn == "dense+moe":
            out = mlp(lp["mlp"], h, tp.get("mlp")) + out
        return x + out, aux

    # ----------------------------------------------------------- serving
    def init_cache(self, batch: int, max_len: int, dtype, device) -> dict:
        """This position's empty decode cache for one repeat (reference
        ``_layer_cache``): this rank's heads under TP."""
        if self.spec.mixer == "attn":
            cfg, tp = self.attn_cfg, self.tp.get("attn")
            if tp_active(tp):
                cfg = attn_lib._tp_heads(cfg, tp)
            return attn_lib.init_kv_cache(cfg, batch, max_len, dtype, device)
        if self.spec.mixer == "mla":
            return attn_lib.init_mla_cache(self.attn_cfg, batch, max_len,
                                           dtype, device)
        return mamba_lib.init_mamba_cache(self.mamba_cfg, batch, dtype,
                                          device, self.tp.get("mamba"))

    def prefill(self, lp: dict, x, cos, sin, positions, max_len: int,
                inner=None):
        """This position over the prompt (reference ``_prefill_layer``):
        ``(x, cache)``, the cache packed for ``max_len`` positions."""
        tp = self.tp
        h = _norm_apply(self.cfg)(lp["norm_mix"], x)
        if self.spec.mixer == "attn":
            mix, cache = attn_lib.attention_prefill(
                lp["attn"], h, self.attn_cfg, cos, sin, max_len, positions,
                tp=tp.get("attn"))
        elif self.spec.mixer == "mla":
            mix, cache = attn_lib.mla_prefill(
                lp["attn"], h, self.attn_cfg, cos, sin, max_len, positions,
                tp=tp.get("mla"))
        else:
            mix, cache = mamba_lib.mamba2_apply(
                lp["mamba"], h, self.mamba_cfg, return_state=True,
                tp=tp.get("mamba"))
        return self._ffn(lp, x + mix, inner)[0], cache

    def decode(self, lp: dict, x, cache: dict, pos, cos, sin, inner=None):
        """This position at one new position ``pos`` of ``x`` (b, 1, d)
        (reference ``_decode_layer``), ``cache`` (one repeat's) updated in
        place."""
        tp = self.tp
        h = _norm_apply(self.cfg)(lp["norm_mix"], x)
        if self.spec.mixer == "attn":
            mix, _ = attn_lib.attention_decode(
                lp["attn"], h, cache, pos, self.attn_cfg, cos, sin,
                tp=tp.get("attn"))
        elif self.spec.mixer == "mla":
            mix, _ = attn_lib.mla_decode(
                lp["attn"], h, cache, pos, self.attn_cfg, cos, sin,
                tp=tp.get("mla"))
        else:
            mix, _ = mamba_lib.mamba2_decode(lp["mamba"], h, cache,
                                             self.mamba_cfg,
                                             tp=tp.get("mamba"))
        return self._ffn(lp, x + mix, inner)[0]


class _Net(nn.Module):
    """The parameter tree of a :class:`Model` and its forward pass:
    ``batch`` → ``(logits f32, aux)``."""

    def __init__(self, cfg: ModelCfg, a: AttnCfg, s: mamba_lib.Mamba2Cfg,
                 m: moe_lib.MoECfg, compute_dtype: torch.dtype, device=None,
                 tp: Optional[dict] = None, fsdp=None,
                 fsdp_dims: Optional[dict] = None):
        super().__init__()
        if cfg.input_mode not in ("tokens", "embeds", "vlm"):
            raise ValueError(cfg.input_mode)
        self.cfg, self.attn_cfg, self.compute_dtype = cfg, a, compute_dtype
        self.tp = tp or {}
        # the FSDP group and each split leaf's dim (by its dotted name)
        self.fsdp = fsdp
        self.fsdp_dims = {n: d for n, d in (fsdp_dims or {}).items()
                          if d is not None}
        self.embed = _Params({"table": (cfg.vocab, cfg.d_model)}, (), device)
        self.blocks = nn.Module()
        for pos, spec in enumerate(cfg.pattern):
            self.blocks.add_module(f"pos{pos}",
                                   _Layer(cfg, a, s, m, spec, device, tp))
        self.final_norm = _norm(cfg, (), device)
        if not cfg.tie_embeddings:
            self.lm_head = _dense(cfg.d_model, cfg.vocab, (), device)

    def _gathered(self, tree: dict, prefix: str, reduce: bool) -> dict:
        """``tree`` (the params under ``prefix``) with every leaf that is
        split over the FSDP axis all-gathered whole."""
        if not self.fsdp_dims:
            return tree
        out = {}
        for k, v in tree.items():
            name = f"{prefix}.{k}" if prefix else k
            if isinstance(v, dict):
                out[k] = self._gathered(v, name, reduce)
            elif name in self.fsdp_dims:
                out[k] = gather_from_data(v, self.fsdp, self.fsdp_dims[name],
                                          reduce)
            else:
                out[k] = v
        return out

    def _embed_inputs(self, batch, table):
        """The first layer's input (reference ``_embed_inputs``): token
        embeddings, the given frame embeddings, or the patch embeddings
        followed by the token embeddings, in the compute dtype."""
        cd, mode = self.compute_dtype, self.cfg.input_mode
        if mode == "embeds":
            return batch["embeds"].to(cd)
        x = embed({"table": table}, batch["tokens"],
                  self.tp.get("vocab")).to(cd)
        if mode == "vlm":
            x = torch.cat([batch["patch_embeds"].to(cd), x], dim=1)
        return x

    def forward(self, *args, op: Optional[str] = None, **kwargs):
        """The training pass (:meth:`logits`), or the serving method ``op``
        (:meth:`prefill_fast`, :meth:`decode`, :meth:`prefill`), under the
        params ``functional_call`` put in place."""
        return getattr(self, op or "logits")(*args, **kwargs)

    def _top(self, reduce: bool) -> dict:
        """The embedding and head leaves, gathered whole under FSDP."""
        return self._gathered({"embed": _tree(self.embed)}
                              | ({} if self.cfg.tie_embeddings else
                                 {"lm_head": _tree(self.lm_head)}), "",
                              reduce)

    def _layers(self) -> list:
        return [getattr(self.blocks, f"pos{pos}")
                for pos in range(len(self.cfg.pattern))]

    def _rope(self, max_len: int, device):
        cfg = self.cfg
        return rope_freqs(cfg.qk_rope_dim if cfg.use_mla
                          else self.attn_cfg.head_dim, max_len,
                          cfg.rope_theta, device=device)

    def _head(self, x, top: dict, whole: bool = False):
        """Final norm and f32 logits; under a vocab split this rank's
        slice, or with ``whole`` the ranks' slices gathered."""
        cfg = self.cfg
        x = _norm_apply(cfg)(_tree(self.final_norm), x)
        head = (top["embed"]["table"].T if cfg.tie_embeddings
                else top["lm_head"]["w"])
        vocab = self.tp.get("vocab")
        x = copy_to_model(x, vocab)
        logits = torch.matmul(x.to(torch.float32), head.to(torch.float32))
        if whole and vocab is not None:
            logits = vocab.all_gather(logits.contiguous(), logits.dim() - 1)
        return logits

    def logits(self, batch, remat: str = "none", inner=None):
        cfg = self.cfg
        # FSDP's gradient sums over the data ranks where they split the
        # batch, and not where each ran it whole
        reduce = inner is not None
        top = self._top(reduce)
        x = self._embed_inputs(batch, top["embed"]["table"])
        b, s, _ = x.shape
        cos, sin = self._rope(s, x.device)
        positions = torch.arange(s, device=x.device).expand(b, s)
        layers = self._layers()
        aux = torch.zeros((), dtype=torch.float32, device=x.device)
        for i in range(cfg.n_repeats):
            # repeat i's params are sliced outside the checkpointed pass,
            # so its recomputation reads the same tensors
            lps = [_tree(layer, i) for layer in layers]

            def block(x, lps=lps):
                block_aux = torch.zeros((), dtype=torch.float32,
                                        device=x.device)
                for pos, (layer, lp) in enumerate(zip(layers, lps)):
                    # gathered inside the pass: remat frees the whole
                    # leaves and gathers them again in the recomputation
                    lp = self._gathered(lp, f"blocks.pos{pos}", reduce)
                    x, a = layer(lp, x, cos, sin, positions, inner)
                    block_aux = block_aux + a
                return x, block_aux

            if remat == "full":
                x, block_aux = torch.utils.checkpoint.checkpoint(
                    block, x, use_reentrant=False)
            else:
                x, block_aux = block(x)
            aux = aux + block_aux
        return self._head(x, top), aux

    # ----------------------------------------------------------- serving
    def init_cache(self, batch: int, max_len: int, device) -> dict:
        """The empty decode cache, one dict per pattern position, each leaf
        stacked over the repeats (reference ``init_cache``)."""
        out = {}
        for pos, layer in enumerate(self._layers()):
            one = layer.init_cache(batch, max_len, self.compute_dtype, device)
            out[f"pos{pos}"] = {
                k: v.unsqueeze(0).repeat((self.cfg.n_repeats,)
                                         + (1,) * v.dim())
                for k, v in one.items()}
        return out

    def _repeats(self):
        """``(i, pos, layer, lp)`` in order: repeat i's params of each
        pattern position, gathered whole under FSDP."""
        layers = self._layers()
        for i in range(self.cfg.n_repeats):
            for pos, layer in enumerate(layers):
                yield i, pos, layer, self._gathered(
                    _tree(layer, i), f"blocks.pos{pos}", False)

    def prefill_fast(self, batch, max_len: Optional[int] = None,
                     inner=None):
        """One pass over the prompt: ``(last-position logits f32, cache)``
        (reference ``prefill_fast``)."""
        top = self._top(False)
        x = self._embed_inputs(batch, top["embed"]["table"])
        b, s, _ = x.shape
        max_len = max_len or s
        cos, sin = self._rope(max_len, x.device)
        positions = torch.arange(s, device=x.device).expand(b, s)
        caches = [[] for _ in self.cfg.pattern]
        for _, pos, layer, lp in self._repeats():
            x, c = layer.prefill(lp, x, cos, sin, positions, max_len, inner)
            caches[pos].append(c)
        cache = {f"pos{pos}": {k: torch.stack([c[k] for c in cs])
                               for k in cs[0]}
                 for pos, cs in enumerate(caches)}
        return self._head(x[:, -1:], top, whole=True)[:, 0], cache

    def decode(self, cache: dict, inputs, pos,
               max_positions: Optional[int] = None, inner=None):
        """One new position for every sequence: ``(logits f32 (b, vocab),
        cache)``, the cache written in place (reference ``decode_step``)."""
        top = self._top(False)
        if inputs.is_floating_point():
            x = inputs.to(self.compute_dtype)
        else:
            x = embed({"table": top["embed"]["table"]}, inputs[:, None],
                      self.tp.get("vocab")).to(self.compute_dtype)
        cos, sin = self._rope(max_positions or self._cache_len(cache),
                              x.device)
        for i, pos_i, layer, lp in self._repeats():
            one = {k: v[i] for k, v in cache[f"pos{pos_i}"].items()}
            x = layer.decode(lp, x, one, pos, cos, sin, inner)
        return self._head(x, top, whole=True)[:, 0], cache

    def _cache_len(self, cache: dict) -> int:
        """The cache's slots (the RoPE table's default length); 1 for a
        pure SSM, whose decode reads no table."""
        for pos, spec in enumerate(self.cfg.pattern):
            if spec.mixer == "attn":
                return cache[f"pos{pos}"]["k"].shape[2]
            if spec.mixer == "mla":
                return cache[f"pos{pos}"]["ckv"].shape[2]
        return 1

    def prefill(self, batch, max_len: Optional[int] = None, inner=None):
        """The prompt one position at a time through :meth:`decode`
        (reference ``prefill``, example scale): ``(last logits, cache)``.
        RoPE reads a table of ``max_len`` positions (the reference's of the
        cache's slots, which a ring shorter than the prompt overruns)."""
        x = self._embed_inputs(batch, self._top(False)["embed"]["table"])
        b, s, _ = x.shape
        max_len = max_len or s
        cache = self.init_cache(b, max_len, x.device)
        logits = None
        for i in range(s):
            logits, cache = self.decode(cache, x[:, i:i + 1], i, max_len,
                                        inner)
        return logits, cache


class Model:
    """Functional model: ``init``, ``apply`` (logits) and ``loss`` over a
    flat param dict; under ``tp`` (a ``TPGroup`` of size > 1) each dict
    holds this rank's shards (:attr:`plan`)."""

    def __init__(self, cfg: ModelCfg, tp=None, fsdp=None):
        self.cfg = cfg
        spans.show_moe(any(p.ffn in ("moe", "dense+moe")
                           for p in cfg.pattern))
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
            d_model=cfg.d_model, d_ff=cfg.expert_d_ff,
            n_experts=cfg.n_experts, top_k=cfg.top_k,
            capacity_factor=cfg.capacity_factor,
            router_aux_weight=cfg.router_aux_weight, gated=cfg.gated_mlp,
            n_groups=cfg.moe_groups, n_shared=cfg.n_shared_experts,
            held=cfg.experts_held, norm_topk=cfg.moe_norm_topk)
        self.mamba_cfg = mamba_lib.Mamba2Cfg(
            d_model=cfg.d_model, d_state=cfg.ssm_state,
            headdim=cfg.ssm_headdim, expand=cfg.ssm_expand,
            chunk=cfg.ssm_chunk)
        self.tp = tp if tp_active(tp) else None
        self.fsdp = fsdp if tp_active(fsdp) else None
        self.plan = None
        splits = {}
        if self.tp is not None or self.fsdp is not None:
            from repro_torch.launch.sharding import shard_plan
            whole = _Net(cfg, self.attn_cfg, self.mamba_cfg, self.moe_cfg,
                         self.compute_dtype, device="meta")
            t, f = self.tp, self.fsdp
            self.plan = shard_plan(cfg, _shapes(whole),
                                   t.size if t else 1, t.index if t else 0,
                                   f.size if f else 1, f.index if f else 0)
            sp = self.plan.splits
            for unit, leaf in (("vocab", "embed.table"),
                               ("attn", ".attn.wq.w"), ("mla", ".attn.wuq.w"),
                               ("mamba", ".mamba.in_proj.w"),
                               ("mlp", ".mlp.wi.w"), ("moe", ".moe.wi")):
                if any(v is not None for n, v in sp.items()
                       if n.endswith(leaf)):
                    splits[unit] = self.tp
        self.net = _Net(cfg, self.attn_cfg, self.mamba_cfg, self.moe_cfg,
                        self.compute_dtype, device="meta", tp=splits,
                        fsdp=self.fsdp,
                        fsdp_dims=self.plan.fsdp if self.plan else None)

    # ------------------------------------------------------------------ init
    def param_shapes(self, whole: bool = False) -> dict:
        """``{name: shape}`` of one worker's params, in leaf order: this
        rank's shards under TP, the whole leaves with ``whole``."""
        shapes = _shapes(self.net)
        if self.plan is None or whole:
            return shapes
        return {n: self.plan.shard_shape(n) for n in shapes}

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
        for name, shape in self.param_shapes(whole=True).items():
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
            if self.plan is not None and self.plan.is_split(name):
                t = self.plan.shard(name, t).clone()
            params[name] = t.to(device)
        return params

    # ----------------------------------------------------------------- forward
    def apply(self, params: dict, batch: dict, remat: str = "none",
              inner=None):
        """Full-sequence forward.  Returns ``(logits f32, aux_loss)``; under
        TP with the vocab split, this rank's slice of the logits.
        ``remat="full"`` recomputes each repeat's pass in the backward
        (plain autograd only).  ``inner``: the group over which the
        worker's batch is split (the aux loss is then this rank's
        share)."""
        if remat not in REMAT:
            raise ValueError(f"remat {remat!r} not in {REMAT}")
        if remat == "full" and \
                torch._C._functorch.peek_interpreter_stack() is not None:
            raise RuntimeError(
                "remat='full' under a torch.func transform (vmap, grad): "
                "torch.func does not support saved-tensor hooks, which "
                "torch.utils.checkpoint is built on; take the gradient with "
                "torch.autograd.grad (the sharded runtime's one worker per "
                "rank) or use remat='none'")
        return torch.func.functional_call(self.net, params, (batch,),
                                          {"remat": remat, "inner": inner})

    def loss(self, params: dict, batch: dict, remat: str = "none",
             inner=None):
        """Next-token cross entropy over ``labels`` (−1 = masked), the mean
        over ``max(#labels, 1)``: ``(ce + aux, {"ce", "aux"})``.  Under the
        ``vlm`` input mode the labels cover the text positions only: they
        are padded with −1 over the image prefix.  With the vocab split
        over the worker's ranks, the vocab-parallel cross entropy.  With
        the worker's batch split over ``inner`` (a ``TPGroup``), this
        rank's share: its ``Σ nll·mask`` over the worker's ``Σ mask``, and
        its share of the aux loss."""
        logits, aux = self.apply(params, batch, remat=remat, inner=inner)
        labels = batch["labels"].long()
        if self.cfg.input_mode == "vlm":
            labels = F.pad(labels, (logits.shape[-2] - labels.shape[-1], 0),
                           value=-1)
        mask = (labels >= 0).to(torch.float32)
        vocab_tp = self.net.tp.get("vocab")
        if vocab_tp is not None:
            nll = vocab_parallel_nll(logits, labels, vocab_tp)
        else:
            logp = F.log_softmax(logits, dim=-1)
            nll = -logp.gather(-1, labels.clamp_min(0)[..., None])[..., 0]
        den = torch.sum(mask)
        if inner is not None:
            den = inner.all_reduce(den.detach().clone(), dist.ReduceOp.SUM)
        ce = torch.sum(nll * mask) / den.clamp_min(1.0)
        return ce + aux, {"ce": ce, "aux": aux}

    # ----------------------------------------------------------------- serving
    def _serve(self, op: str, params: dict, *args, **kwargs):
        with torch.no_grad():
            return torch.func.functional_call(self.net, params, args,
                                              {"op": op, **kwargs})

    def init_cache(self, batch: int, max_len: int, device="cuda") -> dict:
        """The empty decode cache: ``{"pos{i}": {leaf: (n_repeats, batch,
        ...)}}``, a GQA layer's ``{"k", "v", "pos"}`` (``max_len`` slots, a
        ring of ``min(window, max_len)`` with a window), an MLA layer's
        ``{"ckv", "krope", "pos"}``, an SSM layer's ``{"ssm", "conv"}``;
        ``pos`` int32 −1, ``ssm`` f32, the rest in the compute dtype; under
        TP this rank's heads."""
        return self.net.init_cache(batch, max_len, resolve_device(device))

    def prefill_fast(self, params: dict, batch: dict,
                     max_len: Optional[int] = None, inner=None):
        """One pass over the prompt ``batch``: ``(logits f32 (b, vocab) at
        its last position, cache)``, the cache sized for ``max_len``
        positions (the prompt's length by default).  ``inner``: the group
        over which the batch is split (the MoE's capacity is then the
        whole batch's)."""
        return self._serve("prefill_fast", params, batch, max_len=max_len,
                           inner=inner)

    def decode_step(self, params: dict, cache: dict, tokens_or_embeds, pos,
                    max_positions: Optional[int] = None, inner=None):
        """One new token for every sequence: ``tokens_or_embeds`` (b,) int
        tokens or (b, 1, d) embeds at position ``pos`` (the same for the
        batch).  ``max_positions`` sizes the RoPE table (by default the
        cache's slots: pass it for a ring shorter than the sequence).
        Returns ``(logits f32 (b, vocab), cache)``; the cache is written in
        place and returned."""
        return self._serve("decode", params, cache, tokens_or_embeds, pos,
                           max_positions=max_positions, inner=inner)

    def prefill(self, params: dict, batch: dict,
                max_len: Optional[int] = None, inner=None):
        """The prompt one position at a time through the decode step
        (example scale): ``(last logits, cache)``."""
        return self._serve("prefill", params, batch, max_len=max_len,
                           inner=inner)


def _shapes(net: nn.Module) -> dict:
    shapes = {n: tuple(t.shape) for n, t in net.named_parameters()}
    return {n: shapes[n] for n in leaf_order(shapes)}


def make_model(cfg: ModelCfg, tp=None, fsdp=None) -> Model:
    return Model(cfg, tp=tp, fsdp=fsdp)
