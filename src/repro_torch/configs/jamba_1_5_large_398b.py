"""jamba-1.5-large-398b — Jamba 1.5 [arXiv:2403.19887].

72L, d_model 8192, 64 heads (GQA kv=8), d_ff 24576, vocab 65536.
Hybrid Mamba+attention at 1:7 interleave (one attention layer per 8-layer
block) with MoE (16 experts top-2) on every other layer.  The SSM mixer is
implemented with the Mamba-2 SSD algorithm (TPU adaptation: chunked matmul
form instead of Jamba's Mamba-1 CUDA selective scan — noted in DESIGN.md);
state 64, headdim 64.
"""
from repro_torch.configs.base import LayerSpec, ModelCfg, OptimCfg, ParallelCfg, RunCfg

# 8-layer block: attention at position 3 (1:7), MoE on odd positions (1:2).
_PATTERN = tuple(
    LayerSpec(mixer=("attn" if i == 3 else "mamba"),
              ffn=("moe" if i % 2 == 1 else "dense"))
    for i in range(8)
)


def config() -> RunCfg:
    model = ModelCfg(
        name="jamba-1.5-large-398b", arch_type="hybrid",
        n_layers=72, d_model=8192, n_heads=64, n_kv_heads=8,
        d_ff=24576, vocab=65536,
        n_experts=16, top_k=2,
        pattern=_PATTERN,
        ssm_state=64, ssm_headdim=64, ssm_expand=2,
        param_dtype="bfloat16", compute_dtype="bfloat16",
        source="arXiv:2403.19887",
    )
    return RunCfg(model=model, parallel=ParallelCfg(profile="B"),
                  optim=OptimCfg())
