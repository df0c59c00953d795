"""Serving launcher: batched generation on a smoke-scale model.

  PYTHONPATH=src python -m repro_torch.launch.serve --arch olmo-1b \\
      --batch 4 --prompt-len 16 --max-new 16 [--temperature T] [--device cpu]

Port of ``src/repro/launch/serve.py``: the arch's smoke config, params
drawn from seed 0, prompts uniform over the vocabulary from seed 1, one
``generate`` (a prefill and a decode step per new token), and its
throughput.  Runs on the card (``cuda``) unless ``--device cpu``; the
time there ends in ``torch.cuda.synchronize()``.  The reference's
``--devices`` (host devices for XLA) has no counterpart: one process
serves.
"""
from __future__ import annotations

import argparse
import time

__all__ = ["main"]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--arch", required=True)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=16)
    ap.add_argument("--max-new", type=int, default=16)
    ap.add_argument("--temperature", type=float, default=0.0)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    import torch

    from repro_torch import resolve_device
    from repro_torch.configs.registry import get_smoke_config
    from repro_torch.models import make_model
    from repro_torch.serve.serving import generate

    device = resolve_device(args.device)
    run = get_smoke_config(args.arch)
    model = make_model(run.model)
    params = model.init(torch.Generator(device=device).manual_seed(0),
                        device=device)
    prompts = torch.randint(
        0, run.model.vocab, (args.batch, args.prompt_len),
        generator=torch.Generator(device=device).manual_seed(1),
        device=device)
    t0 = time.perf_counter()
    out = generate(model, params, prompts, args.max_new,
                   temperature=args.temperature,
                   generator=torch.Generator(device=device).manual_seed(2))
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    dt = time.perf_counter() - t0
    print(f"arch={args.arch} generated {tuple(out.shape)} on {device} "
          f"({args.batch * args.max_new / dt:.1f} tok/s)")
    print("sample:", out[0].tolist())
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
