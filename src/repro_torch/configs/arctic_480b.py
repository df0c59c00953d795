"""arctic-480b — Snowflake Arctic base [hf:Snowflake/snowflake-arctic-base].

35L, d_model 7168, 56 heads (GQA kv=8), dense d_ff 4864, vocab 32000,
MoE 128 experts top-2 *in parallel with* a dense residual FFN per layer
(Arctic's "dense-MoE hybrid" residual architecture).
"""
from repro_torch.configs.base import LayerSpec, ModelCfg, OptimCfg, ParallelCfg, RunCfg


def config() -> RunCfg:
    model = ModelCfg(
        name="arctic-480b", arch_type="moe",
        n_layers=35, d_model=7168, n_heads=56, n_kv_heads=8,
        d_ff=4864, vocab=32000,
        n_experts=128, top_k=2,
        pattern=(LayerSpec("attn", "dense+moe"),),
        param_dtype="bfloat16", compute_dtype="bfloat16",
        source="hf:Snowflake/snowflake-arctic-base",
    )
    return RunCfg(model=model, parallel=ParallelCfg(profile="B"),
                  optim=OptimCfg())
