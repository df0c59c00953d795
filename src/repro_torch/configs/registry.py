"""Config registry: ``get_config(name)``, smoke-reduction, shape policies.

Port of ``src/repro/configs/registry.py``.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List

from repro_torch.configs import (arctic_480b, internvl2_76b,
                                 jamba_1_5_large_398b, mamba2_1_3b,
                                 minicpm3_4b, mixtral_8x7b, musicgen_medium,
                                 olmo_1b, paper_resnet20, qwen2_72b,
                                 stablelm_12b)
from repro_torch.configs.base import LayerSpec, ModelCfg, RunCfg
from repro_torch.configs.shapes import SHAPES, InputShape

__all__ = ["ARCHS", "get_config", "get_smoke_config", "list_archs",
           "long_ctx_variant", "shape_supported"]

ARCHS = {
    "arctic-480b": arctic_480b.config,
    "mixtral-8x7b": mixtral_8x7b.config,
    "stablelm-12b": stablelm_12b.config,
    "olmo-1b": olmo_1b.config,
    "qwen2-72b": qwen2_72b.config,
    "musicgen-medium": musicgen_medium.config,
    "minicpm3-4b": minicpm3_4b.config,
    "internvl2-76b": internvl2_76b.config,
    "jamba-1.5-large-398b": jamba_1_5_large_398b.config,
    "mamba2-1.3b": mamba2_1_3b.config,
    "paper-resnet20": paper_resnet20.config,
}

ASSIGNED: List[str] = [k for k in ARCHS if k != "paper-resnet20"]


def list_archs() -> List[str]:
    return list(ARCHS)


def get_config(name: str) -> RunCfg:
    if name not in ARCHS:
        raise KeyError(f"unknown arch {name!r}; choose from {list(ARCHS)}")
    return ARCHS[name]()


# --------------------------------------------------------------------- long ctx
LONG_CTX_WINDOW = 8192  # sliding-window applied to full-attention archs @500k


def long_ctx_variant(model: ModelCfg) -> ModelCfg:
    """Model variant used for the long_500k shape.

    SSM/hybrid run natively (O(1)/sparse state).  Archs with a native window
    (mixtral) keep it.  Pure full-attention archs get the sliding-window
    variant (window 8192) — the sub-quadratic requirement of the assignment.
    """
    if model.arch_type in ("ssm", "hybrid"):
        return model
    if model.window is not None:
        return model
    return dataclasses.replace(model, window=LONG_CTX_WINDOW)


def shape_supported(model: ModelCfg, shape: InputShape) -> bool:
    if model.arch_type == "cnn":
        return False  # paper model: trained by the benchmarks, not dryrun
    return True


# --------------------------------------------------------------------- smoke
def get_smoke_config(name: str) -> RunCfg:
    """Reduced same-family variant: 2 layers, d_model ≤ 512, ≤ 4 experts."""
    run = get_config(name)
    m = run.model
    if m.arch_type == "cnn":
        return run
    pattern = m.pattern
    if len(pattern) > 2:  # jamba: keep hybrid character in 2 layers
        pattern = (LayerSpec("mamba", "dense"), LayerSpec("attn", "moe"))
    n_layers = 2 if len(pattern) <= 2 else len(pattern)
    small = dataclasses.replace(
        m,
        n_layers=n_layers,
        pattern=pattern,
        d_model=128,
        n_heads=4,
        n_kv_heads=min(4, max(1, 4 * m.n_kv_heads // m.n_heads)),
        head_dim=32,
        d_ff=min(m.d_ff, 256) if m.d_ff else 0,
        vocab=min(m.vocab, 512),
        n_experts=min(m.n_experts, 4) if m.n_experts else 0,
        window=min(m.window, 64) if m.window else None,
        q_lora_rank=64, kv_lora_rank=32, qk_nope_dim=16, qk_rope_dim=8,
        v_head_dim=16,
        ssm_state=32, ssm_headdim=16, ssm_chunk=16,
        n_patches=16,
        param_dtype="float32", compute_dtype="float32",
    )
    return dataclasses.replace(run, model=small)
