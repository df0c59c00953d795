"""qwen2-72b — Qwen2 [arXiv:2407.10671].

80L, d_model 8192, 64 heads (GQA kv=8), d_ff 29568, vocab 152064.
QKV bias (Qwen's signature), RMSNorm, rope_theta 1e6.
"""
from repro_torch.configs.base import ModelCfg, OptimCfg, ParallelCfg, RunCfg


def config() -> RunCfg:
    model = ModelCfg(
        name="qwen2-72b", arch_type="dense",
        n_layers=80, d_model=8192, n_heads=64, n_kv_heads=8,
        d_ff=29568, vocab=152064, qkv_bias=True, rope_theta=1e6,
        param_dtype="bfloat16", compute_dtype="bfloat16",
        source="arXiv:2407.10671",
    )
    return RunCfg(model=model, parallel=ParallelCfg(profile="B"),
                  optim=OptimCfg())
