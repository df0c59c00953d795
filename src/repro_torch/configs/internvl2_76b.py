"""internvl2-76b — InternVL2 (InternViT-6B + InternLM2-70B) [arXiv:2404.16821].

Language backbone: 80L, d_model 8192, 64 heads (GQA kv=8), d_ff 28672,
vocab 128256.  The InternViT vision encoder + MLP projector are a STUB per
the assignment: ``input_specs()`` provides precomputed patch embeddings
(n_patches=1024 prefix) at d_model; the LM that consumes them is fully
implemented.
"""
from repro_torch.configs.base import ModelCfg, OptimCfg, ParallelCfg, RunCfg


def config() -> RunCfg:
    model = ModelCfg(
        name="internvl2-76b", arch_type="vlm",
        n_layers=80, d_model=8192, n_heads=64, n_kv_heads=8,
        d_ff=28672, vocab=128256,
        input_mode="vlm", n_patches=1024,   # ViT patch count  # lint: allow
        param_dtype="bfloat16", compute_dtype="bfloat16",
        source="arXiv:2404.16821",
    )
    return RunCfg(model=model, parallel=ParallelCfg(profile="B"),
                  optim=OptimCfg())
