"""Ablation on the PyTorch port: compression operator × consensus step γ ×
topology.

The port's counterpart of ``examples/compression_ablation.py``: CPD-SGDM
on the tiny LM with each operator's real wire payload, on a ring and on
the exponential graph, so the comm-MB column is the exact bytes a sharded
run would move.  Runs on the flatten-once kernel layout: on the card the
sign, QSGD and top-k wires are the port's CUDA codec kernels; identity
and rand-k ship through the per-leaf codec.

  PYTHONPATH=src python examples/torch_compression_ablation.py
  PYTHONPATH=src python examples/torch_compression_ablation.py --device cpu

``--steps N`` (default ``ABLATION_STEPS`` from the environment, else 50)
trims the run, as CI's ``ABLATION_STEPS=8`` does for the reference.
"""
import argparse
import os

import torch

from repro_torch import resolve_device
from repro_torch.configs.base import ModelCfg
from repro_torch.core import (CPDSGDM, CPDSGDMConfig, DenseComm,
                              IdentityCompressor, QSGDCompressor,
                              RandKCompressor, SignCompressor,
                              TopKCompressor, exponential, ring)
from repro_torch.data.synthetic import LMStreamCfg, lm_batch
from repro_torch.models import make_model
from repro_torch.train.trainer import SimTrainer

K = 8
TINY = ModelCfg(name="t", arch_type="dense", n_layers=2, d_model=64,
                n_heads=4, n_kv_heads=2, d_ff=128, vocab=256)
# (compressor, γ): the reference's grid
GRID = [(IdentityCompressor(), 0.4), (SignCompressor(), 0.4),
        (QSGDCompressor(levels=7), 0.4), (TopKCompressor(fraction=0.1), 0.15),
        (RandKCompressor(fraction=0.1), 0.1)]


def main(argv=None) -> list:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--steps", type=int,
                    default=int(os.environ.get("ABLATION_STEPS", "50")))
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    steps = args.steps
    model = make_model(TINY)
    x0 = model.init(torch.Generator(device=device).manual_seed(0),
                    device=device)
    params0 = {n: v.expand((K,) + v.shape).contiguous()
               for n, v in x0.items()}
    data = LMStreamCfg(vocab=256, seq_len=32, batch=4, n_workers=K)
    print(f"{'compressor':<14}{'topology':<13}{'gamma':>6}{'rho':>7}"
          f"{'final loss':>12}{'comm MB':>9}")
    rows = []
    for comp, gamma in GRID:
        for topo in [ring(K), exponential(K)]:
            opt = CPDSGDM(CPDSGDMConfig(eta=0.3, mu=0.9, p=4, gamma=gamma,
                                        use_kernel=True),
                          DenseComm(topo, device=device), comp)
            trainer = SimTrainer(lambda p, b: model.loss(p, b), opt,
                                 device=device)
            _, _, h = trainer.train(params0,
                                    lambda t: lm_batch(data, t, device),
                                    steps, log_every=max(steps - 1, 1))
            print(f"{comp.name:<14}{topo.name:<13}{gamma:>6.2f}"
                  f"{topo.rho:>7.3f}{h.loss[-1]:>12.4f}{h.comm_mb[-1]:>9.2f}")
            rows.append({"compressor": comp.name, "topology": topo.name,
                         "gamma": gamma, "loss": h.loss,
                         "comm_mb": h.comm_mb[-1]})
    return rows


if __name__ == "__main__":
    main()
