"""Operations and bytes from shapes: the yardstick of the per-layer metrics.

Every count here is a function of the configuration's shapes and the
traffic's sizes, and counts the work the algorithm needs (each input byte
read once, each output byte written once, each product of the model once,
no recomputation), so it reads the same whatever implements the kernel.

The kernel layout is the port's flatten-once ``(K, rows, 1024)`` f32
matrix: each leaf starts on a fresh row of ``LANE`` elements, and the rows
are padded up to a multiple of ``BLOCK_ROWS``.  Its arithmetic is copied
here so that the yardstick does not move when the program does.

The FLOP count takes every layer kind a pattern entry can state (mixer
``attn``, ``mla`` or ``mamba``; ffn ``dense``, ``moe``, ``dense+moe`` or
``none``) from the configuration file's ``model`` keys.  Beside the
program's own field names (``n_experts``, ``top_k``, ``q_lora_rank``,
``kv_lora_rank``, ``qk_nope_dim``, ``qk_rope_dim``, ``v_head_dim``,
``window``), three optional keys are the names a configuration's file
uses for sizes the program's fields do not state:

* ``moe_d_ff``: an expert's width, where it is not ``d_ff`` (default
  ``d_ff``);
* ``n_shared_experts``: experts every token passes through beside the
  routed ones (default 0);
* ``experts_held``: how many of the ``n_experts`` routed experts this
  card holds, the card's share of a layer divided over several (default
  ``n_experts``).

A routed expert's term is the expectation under even routing: each token
sends ``top_k`` slots, of which ``experts_held / n_experts`` land on the
experts held here.  A slot that capacity drops still counts: the
algorithm asks for it, whatever the program does with it.
"""
from __future__ import annotations

import math

LANE = 1024
BLOCK_ROWS = 256
F32 = 4


def leaf_sizes(shapes: dict) -> list:
    """Elements of each leaf of one worker."""
    return [math.prod(s) if s else 1 for s in shapes.values()]


def param_count(shapes: dict) -> int:
    return sum(leaf_sizes(shapes))


def layout_rows(shapes: dict) -> tuple:
    """``(rows, used_rows)`` of one worker on the kernel layout: every leaf
    on ``ceil(size / LANE)`` fresh rows, the total padded to a multiple of
    ``BLOCK_ROWS``."""
    used = sum(-(-n // LANE) for n in leaf_sizes(shapes))
    return -(-used // BLOCK_ROWS) * BLOCK_ROWS, used


# ------------------------------------------------------------------ FLOPs
def _mixers(model: dict) -> list:
    """The mixer of every layer (the pattern repeated over the depth)."""
    pattern = model["pattern"]
    return [p["mixer"] for p in pattern] * (model["n_layers"] // len(pattern))


def _ffns(model: dict) -> list:
    pattern = model["pattern"]
    return [p["ffn"] for p in pattern] * (model["n_layers"] // len(pattern))


def head_dim(model: dict) -> int:
    return model.get("head_dim") or model["d_model"] // model["n_heads"]


def ssm_dims(model: dict) -> dict:
    """The SSD mixer's widths (one group, as published)."""
    d_inner = model["ssm_expand"] * model["d_model"]
    heads = d_inner // model["ssm_headdim"]
    conv = d_inner + 2 * model["ssm_state"]
    return {"d_inner": d_inner, "heads": heads, "conv_dim": conv,
            "in_proj": d_inner + conv + heads}


def attention_keys(model: dict, seq: int) -> int:
    """Keys a query of an attention layer sees over the whole score
    matrix: ``seq``, or the window where one is set and shorter."""
    window = model.get("window")
    return min(window, seq) if window else seq


def mla_params(model: dict) -> int:
    """An MLA mixer's projections: q (through ``q_lora_rank``, or direct
    where that is 0 or null), the joint kv latent and the shared rope key
    (``kv_a``), the latent's up-projection to keys and values (``kv_b``),
    and the output."""
    d, h = model["d_model"], model["n_heads"]
    qk = model["qk_nope_dim"] + model["qk_rope_dim"]
    q_lora, kv_lora = model["q_lora_rank"], model["kv_lora_rank"]
    q = d * q_lora + q_lora * h * qk if q_lora else d * h * qk
    kv_a = d * (kv_lora + model["qk_rope_dim"])
    kv_b = kv_lora * h * (model["qk_nope_dim"] + model["v_head_dim"])
    return q + kv_a + kv_b + h * model["v_head_dim"] * d


def moe_params(model: dict) -> float:
    """The weights of an expert layer that multiply a token, as an
    expectation: the router over all ``n_experts``, ``top_k`` routed
    experts of width ``moe_d_ff`` of which the share ``experts_held /
    n_experts`` lies here, and every shared expert."""
    d, n_experts = model["d_model"], model["n_experts"]
    expert = (3 if model["gated_mlp"] else 2) * d * model.get(
        "moe_d_ff", model["d_ff"])
    held = model.get("experts_held", n_experts)
    return (d * n_experts + model["top_k"] * held * expert / n_experts
            + model.get("n_shared_experts", 0) * expert)


def matmul_params(model: dict) -> float:
    """Weights that multiply an activation once per token: every
    projection of every layer and the output head (the embedding lookup
    multiplies nothing); an expert layer's by :func:`moe_params`."""
    d = model["d_model"]
    n = 0
    for mixer in _mixers(model):
        if mixer == "attn":
            hd = head_dim(model)
            n += d * hd * (2 * model["n_heads"] + 2 * model["n_kv_heads"])
        elif mixer == "mla":
            n += mla_params(model)
        elif mixer == "mamba":
            s = ssm_dims(model)
            n += d * s["in_proj"] + s["d_inner"] * d
        else:
            raise ValueError(f"no FLOP count for mixer {mixer!r}")
    dense = d * model["d_ff"] * (3 if model["gated_mlp"] else 2)
    for ffn in _ffns(model):
        if ffn in ("dense", "dense+moe"):
            n += dense
        if ffn in ("moe", "dense+moe"):
            n += moe_params(model)
        elif ffn not in ("dense", "none"):
            raise ValueError(f"no FLOP count for ffn {ffn!r}")
    return n + d * model["vocab"]


def attention_flops_per_token(model: dict, seq: int) -> float:
    """Scores and weighted values of every attention layer, forward and
    backward, over the whole score matrix (PaLM's count): ``6 · keys ·
    heads · (qk width + v width)`` a layer, which for ``attn`` is ``12 ·
    d_attn · keys``; ``keys`` is :func:`attention_keys`."""
    keys, n = attention_keys(model, seq), 0.0
    for mixer in _mixers(model):
        if mixer == "attn":
            width = 2 * head_dim(model)
        elif mixer == "mla":
            width = (model["qk_nope_dim"] + model["qk_rope_dim"]
                     + model["v_head_dim"])
        else:
            continue
        n += 6.0 * keys * model["n_heads"] * width
    return n


def ssd_flops_per_token(model: dict, seq: int) -> float:
    """The chunked SSD's contractions, forward and backward (3×): per head
    and token ``2·Q·d_state`` (C·Bᵀ in the chunk), ``2·Q·headdim`` (the
    weighted x), ``2·d_state·headdim`` (the chunk state) and as much for
    the state's output, with Q = min(chunk, seq)."""
    n = sum(m == "mamba" for m in _mixers(model))
    if not n:
        return 0.0
    q = min(model["ssm_chunk"], seq)
    ds, hd = model["ssm_state"], model["ssm_headdim"]
    heads = ssm_dims(model)["heads"]
    return 3.0 * n * heads * (2 * q * ds + 2 * q * hd + 4 * ds * hd)


def model_flops_per_token(model: dict, seq: int) -> float:
    """``6 · matmul params`` plus the attention or SSD terms."""
    return (6.0 * matmul_params(model) + attention_flops_per_token(model, seq)
            + ssd_flops_per_token(model, seq))


# ------------------------------------------------------------------ bytes
def momentum_bytes(workers: int, elems: int) -> int:
    """One momentum update of ``elems`` parameters a worker, in place:
    read x, m and g, write x and m."""
    return 5 * workers * elems * F32


def gossip_bytes(workers: int, elems: int) -> int:
    """One gossip mix: read x once, write the mix once."""
    return 2 * workers * elems * F32


def sign_codec_bytes(workers: int, elems: int, blocks: int) -> int:
    """One sign pack and one unpack of ``elems`` f32 in ``blocks`` blocks
    of ``LANE`` a worker: the pack reads the values and each block's valid
    count and writes a bit an element and a scale a block; the unpack
    reads bits and scales and writes the values."""
    packed = blocks * (LANE // 8 + F32)
    pack = elems * F32 + blocks * F32 + packed
    unpack = packed + elems * F32
    return workers * (pack + unpack)


def bound_ms(nbytes: float, peaks: dict) -> float:
    """The least time the card's HBM needs for ``nbytes``."""
    return nbytes / peaks["hbm_bytes_per_s"] * 1e3
