"""musicgen-medium — MusicGen [arXiv:2306.05284].

48L decoder-only over EnCodec tokens: d_model 1536, 24 heads (MHA kv=24),
d_ff 6144, vocab 2048.  The EnCodec frontend is a STUB per the assignment:
``input_specs()`` provides precomputed frame embeddings; the decoder and its
2048-way codec-token head are fully implemented.  (Single-codebook
simplification of MusicGen's 4-codebook interleaving — noted in DESIGN.md.)
"""
from repro_torch.configs.base import ModelCfg, OptimCfg, ParallelCfg, RunCfg


def config() -> RunCfg:
    model = ModelCfg(
        name="musicgen-medium", arch_type="audio",
        n_layers=48, d_model=1536, n_heads=24, n_kv_heads=24,
        d_ff=6144, vocab=2048, norm="layernorm", gated_mlp=False,
        input_mode="embeds",
        param_dtype="bfloat16", compute_dtype="bfloat16",
        source="arXiv:2306.05284",
    )
    return RunCfg(model=model, parallel=ParallelCfg(profile="A"),
                  optim=OptimCfg())
