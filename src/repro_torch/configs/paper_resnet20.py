"""paper-resnet20 — the paper's own CIFAR-10 experimental model (He '16).

Used by the faithful-reproduction benchmarks (Fig. 1-3): ring of 8 workers,
PD-SGDM/CPD-SGDM vs C-SGDM, momentum 0.9, weight decay 1e-4, sign
compression, consensus step 0.4.
"""
from repro_torch.configs.base import ModelCfg, OptimCfg, ParallelCfg, RunCfg


def config() -> RunCfg:
    # ModelCfg fields are mostly unused for the CNN; kept for registry shape.
    model = ModelCfg(
        name="paper-resnet20", arch_type="cnn",
        n_layers=20, d_model=64, n_heads=1, n_kv_heads=1,
        d_ff=0, vocab=10,
        source="He et al. 2016 (paper §5.1)",
    )
    return RunCfg(model=model, parallel=ParallelCfg(profile="A"),
                  optim=OptimCfg(eta=0.1, mu=0.9, p=4, gamma=0.4,
                                 weight_decay=1e-4))
