"""Operations and bytes from shapes: the yardstick of the per-layer metrics.

Every count here is a function of the configuration's shapes and the
traffic's sizes, and counts the work the algorithm needs (each input byte
read once, each output byte written once, each product of the model once,
no recomputation), so it reads the same whatever implements the kernel.

The kernel layout is the port's flatten-once ``(K, rows, 1024)`` f32
matrix: each leaf starts on a fresh row of ``LANE`` elements, and the rows
are padded up to a multiple of ``BLOCK_ROWS``.  Its arithmetic is copied
here so that the yardstick does not move when the program does.
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


def matmul_params(model: dict) -> int:
    """Weights that multiply an activation once per token: every
    projection of every layer and the output head (the embedding lookup
    multiplies nothing)."""
    d = model["d_model"]
    n = 0
    for mixer in _mixers(model):
        if mixer == "attn":
            hd = head_dim(model)
            n += d * hd * (2 * model["n_heads"] + 2 * model["n_kv_heads"])
        elif mixer == "mamba":
            s = ssm_dims(model)
            n += d * s["in_proj"] + s["d_inner"] * d
        else:
            raise ValueError(f"no FLOP count for mixer {mixer!r}")
    for ffn in _ffns(model):
        if ffn == "dense":
            n += d * model["d_ff"] * (3 if model["gated_mlp"] else 2)
        elif ffn != "none":
            raise ValueError(f"no FLOP count for ffn {ffn!r}")
    return n + d * model["vocab"]


def attention_flops_per_token(model: dict, seq: int) -> float:
    """Scores and weighted values of every attention layer, forward and
    backward: ``12 · d_attn · seq`` a layer (PaLM's count, over the whole
    score matrix)."""
    n = sum(m == "attn" for m in _mixers(model))
    return 12.0 * n * model["n_heads"] * head_dim(model) * seq


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
