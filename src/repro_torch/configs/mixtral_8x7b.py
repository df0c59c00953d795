"""mixtral-8x7b — Mixtral of Experts [arXiv:2401.04088].

32L, d_model 4096, 32 heads (GQA kv=8), d_ff 14336, vocab 32000,
MoE 8 experts top-2, sliding-window attention (4096).
"""
from repro_torch.configs.base import LayerSpec, ModelCfg, OptimCfg, ParallelCfg, RunCfg


def config() -> RunCfg:
    model = ModelCfg(
        name="mixtral-8x7b", arch_type="moe",
        n_layers=32, d_model=4096, n_heads=32, n_kv_heads=8,
        d_ff=14336, vocab=32000,
        n_experts=8, top_k=2, window=4096,
        pattern=(LayerSpec("attn", "moe"),),
        param_dtype="bfloat16", compute_dtype="bfloat16",
        source="arXiv:2401.04088",
    )
    return RunCfg(model=model, parallel=ParallelCfg(profile="B"),
                  optim=OptimCfg())
