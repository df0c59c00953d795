"""Ablation on the PyTorch port: data heterogeneity (non-IID Dirichlet
splits) × communication period p × optimizer (plain momentum vs momentum
tracking).

The port's counterpart of ``examples/noniid_ablation.py``: ResNet-20 at
width 4, K = 8 workers on a ring drawing labels from Dirichlet(α) class
distributions (small α = strongly non-IID), PD-SGDM and MT-DSGDm at each
one's step size over a grid of p, through ``SimTrainer`` on the
flatten-once kernel layout.

  PYTHONPATH=src python examples/torch_noniid_ablation.py
  PYTHONPATH=src python examples/torch_noniid_ablation.py --device cpu

``--steps N`` (default ``ABLATION_STEPS`` from the environment, else 50)
trims the run; at 8 steps or fewer the grid shrinks too, as the
reference's CI smoke does.
"""
import argparse
import os

import torch

from repro_torch import resolve_device
from repro_torch.core import DenseComm, make_optimizer, ring
from repro_torch.data.synthetic import ClassStreamCfg, class_batch
from repro_torch.models.resnet import resnet20_init, resnet20_loss
from repro_torch.train.trainer import SimTrainer

K = 8
# per-optimizer step size: the tracked correction ages p steps between
# mixes and diverges for large p·η (see benchmarks/noniid_sweep.py), so MT
# runs its stable region at η = 0.05 while PD-SGDM keeps η = 0.1
ETA = {"pd_sgdm": 0.1, "mt_dsgdm": 0.05}


def main(argv=None) -> list:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--steps", type=int,
                    default=int(os.environ.get("ABLATION_STEPS", "50")))
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    steps = args.steps
    smoke = steps <= 8
    alphas = [None, 0.1] if smoke else [None, 1.0, 0.1]
    ps_by_opt = {"pd_sgdm": [1, 4] if smoke else [1, 4, 16],
                 "mt_dsgdm": [2] if smoke else [1, 2]}
    x0 = resnet20_init(torch.Generator(device=device).manual_seed(0),
                       width=4, device=device)
    params0 = {n: v.expand((K,) + v.shape).contiguous()
               for n, v in x0.items()}
    print(f"{'alpha':>8}{'p':>4}{'optimizer':>11}{'final loss':>12}"
          f"{'comm MB':>9}")
    rows = []
    for alpha in alphas:
        for name in ["pd_sgdm", "mt_dsgdm"]:
            for p in ps_by_opt[name]:
                cfg = ClassStreamCfg(batch=16, n_workers=K,
                                     dirichlet_alpha=alpha)
                opt = make_optimizer(name, DenseComm(ring(K), device=device),
                                     eta=ETA[name], mu=0.9, p=p,
                                     weight_decay=1e-4, use_kernel=True)
                trainer = SimTrainer(resnet20_loss, opt, device=device)
                _, _, h = trainer.train(
                    params0, lambda t: class_batch(cfg, t, device), steps,
                    log_every=max(steps - 1, 1))
                label = "IID" if alpha is None else f"{alpha:g}"
                print(f"{label:>8}{p:>4}{name:>11}"
                      f"{h.loss[-1]:>12.4f}{h.comm_mb[-1]:>9.2f}")
                rows.append({"alpha": alpha, "p": p, "optimizer": name,
                             "loss": h.loss, "comm_mb": h.comm_mb[-1]})
    print("\nreading: within every alpha row the loss degrades as p grows — "
          "the staleness Theorem 1 prices via p²G²/ρ².  The local loss is "
          "easier under strong non-IID (a worker seeing few classes has a "
          "simpler problem); judge heterogeneity on the averaged model over "
          "the global distribution (SimTrainer's eval_fn hook).  MT's comm "
          "MB column shows its (x, c) wire costing twice PD-SGDM's.")
    return rows


if __name__ == "__main__":
    main()
