"""olmo-1b — OLMo [arXiv:2402.00838].

16L, d_model 2048, 16 heads (MHA: kv=16), d_ff 8192, vocab 50304.
Non-parametric LayerNorm (no scale/bias) — OLMo's signature choice.
"""
from repro_torch.configs.base import ModelCfg, OptimCfg, ParallelCfg, RunCfg


def config() -> RunCfg:
    model = ModelCfg(
        name="olmo-1b", arch_type="dense",
        n_layers=16, d_model=2048, n_heads=16, n_kv_heads=16,
        d_ff=8192, vocab=50304, norm="nonparametric", gated_mlp=False,
        param_dtype="bfloat16", compute_dtype="bfloat16",
        source="arXiv:2402.00838",
    )
    return RunCfg(model=model, parallel=ParallelCfg(profile="A"),
                  optim=OptimCfg())
