"""stablelm-12b — Stable LM 2 family [hf:stabilityai/stablelm-2-1_6b].

40L, d_model 5120, 32 heads (GQA kv=8), d_ff 13824, vocab 100352.
LayerNorm (with bias) per the Stable LM 2 architecture.
"""
from repro_torch.configs.base import ModelCfg, OptimCfg, ParallelCfg, RunCfg


def config() -> RunCfg:
    model = ModelCfg(
        name="stablelm-12b", arch_type="dense",
        n_layers=40, d_model=5120, n_heads=32, n_kv_heads=8,
        d_ff=13824, vocab=100352, norm="layernorm",
        param_dtype="bfloat16", compute_dtype="bfloat16",
        source="hf:stabilityai/stablelm-2-1_6b",
    )
    return RunCfg(model=model, parallel=ParallelCfg(profile="A"),
                  optim=OptimCfg())
