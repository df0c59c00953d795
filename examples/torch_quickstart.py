"""Quickstart on the PyTorch port: decentralized momentum SGD (PD-SGDM).

The port's counterpart of ``examples/quickstart.py``: 8 workers on a ring
train a tiny LM with local momentum steps and gossip every p = 4
iterations; the same run with sign-compressed gossip (CPD-SGDM) shows the
~30× communication saving at matching loss; and a time-varying one-peer
exponential topology ships one neighbour's params a round.  Every run
goes through ``SimTrainer`` on the flatten-once kernel layout, so on the
card the momentum step, the ring's gossip and the sign wire are the
port's CUDA kernels.

  PYTHONPATH=src python examples/torch_quickstart.py               # card
  PYTHONPATH=src python examples/torch_quickstart.py --device cpu  # CPU

``--steps N`` trims the run (same code path, just short).
"""
import argparse

import torch

from repro_torch import resolve_device
from repro_torch.configs.base import ModelCfg
from repro_torch.core import (CPDSGDM, PDSGDM, CPDSGDMConfig, DenseComm,
                              PDSGDMConfig, SignCompressor, make_schedule,
                              ring)
from repro_torch.data.synthetic import LMStreamCfg, lm_batch
from repro_torch.models import make_model
from repro_torch.train.trainer import SimTrainer

K = 8       # workers on a ring (the paper's setup)
TINY = ModelCfg(name="tiny-lm", arch_type="dense", n_layers=2, d_model=64,
                n_heads=4, n_kv_heads=2, d_ff=128, vocab=256)


def main(argv=None) -> list:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--steps", type=int, default=60)
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    model = make_model(TINY)
    # every worker starts from the same x0 (Algorithm 1's input)
    x0 = model.init(torch.Generator(device=device).manual_seed(0),
                    device=device)
    params0 = {n: v.expand((K,) + v.shape).contiguous()
               for n, v in x0.items()}
    data = LMStreamCfg(vocab=256, seq_len=32, batch=4, n_workers=K)
    rows = []
    for label, opt in [
        ("PD-SGDM  (Alg.1, full-precision gossip)",
         PDSGDM(PDSGDMConfig(eta=0.3, mu=0.9, p=4, use_kernel=True),
                DenseComm(ring(K), device=device))),
        ("CPD-SGDM (Alg.2, 1-bit sign gossip)",
         CPDSGDM(CPDSGDMConfig(eta=0.3, mu=0.9, p=4, gamma=0.4,
                               use_kernel=True),
                 DenseComm(ring(K), device=device), SignCompressor())),
        ("PD-SGDM  (one-peer exponential schedule, degree 1)",
         PDSGDM(PDSGDMConfig(eta=0.3, mu=0.9, p=4, use_kernel=True),
                DenseComm(make_schedule("one_peer_exp", (K,)),
                          device=device))),
    ]:
        trainer = SimTrainer(lambda p, b: model.loss(p, b), opt,
                             device=device, rounds_per_log=5)
        _, _, hist = trainer.train(params0,
                                   lambda t: lm_batch(data, t, device),
                                   steps=args.steps, log_every=20)
        print(f"{label}\n  loss {hist.loss[0]:.3f} -> {hist.loss[-1]:.3f}   "
              f"communicated {hist.comm_mb[-1]:.2f} MB over "
              f"{args.steps // opt.config.p} rounds\n")
        rows.append({"label": label, "loss": hist.loss,
                     "comm_mb": hist.comm_mb[-1]})
    return rows


if __name__ == "__main__":
    main()
