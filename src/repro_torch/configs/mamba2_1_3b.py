"""mamba2-1.3b — Mamba-2 / SSD [arXiv:2405.21060].

48L, d_model 2048, attention-free, vocab 50280, ssm_state 128, headdim 64,
expand 2 (d_inner 4096, 64 SSD heads).  Pure SSM: O(1) decode state, no KV
cache — runs long_500k natively.
"""
from repro_torch.configs.base import LayerSpec, ModelCfg, OptimCfg, ParallelCfg, RunCfg


def config() -> RunCfg:
    model = ModelCfg(
        name="mamba2-1.3b", arch_type="ssm",
        n_layers=48, d_model=2048, n_heads=32, n_kv_heads=32,
        d_ff=0, vocab=50280,
        pattern=(LayerSpec("mamba", "none"),),
        ssm_state=128, ssm_headdim=64, ssm_expand=2,
        param_dtype="bfloat16", compute_dtype="bfloat16",
        source="arXiv:2405.21060",
    )
    return RunCfg(model=model, parallel=ParallelCfg(profile="A"),
                  optim=OptimCfg())
