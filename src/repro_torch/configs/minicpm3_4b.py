"""minicpm3-4b — MiniCPM3 [hf:openbmb/MiniCPM3-4B].

62L, d_model 2560, 40 heads, d_ff 6400, vocab 73448, with MLA
(multi-head latent attention): q_lora 768, kv_lora 256, qk nope/rope 64/32,
v_head 64 — the compressed-KV-cache attention of DeepSeek-V2 lineage.
"""
from repro_torch.configs.base import LayerSpec, ModelCfg, OptimCfg, ParallelCfg, RunCfg


def config() -> RunCfg:
    model = ModelCfg(
        name="minicpm3-4b", arch_type="dense",
        n_layers=62, d_model=2560, n_heads=40, n_kv_heads=40,
        d_ff=6400, vocab=73448,
        use_mla=True, q_lora_rank=768, kv_lora_rank=256,
        qk_nope_dim=64, qk_rope_dim=32, v_head_dim=64,
        pattern=(LayerSpec("mla", "dense"),),
        param_dtype="bfloat16", compute_dtype="bfloat16",
        source="hf:openbmb/MiniCPM3-4B",
    )
    return RunCfg(model=model, parallel=ParallelCfg(profile="A"),
                  optim=OptimCfg())
