"""Serve three small models with batched requests: prefill + streaming
decode, on the PyTorch port.

The counterpart of ``examples/serve_batched.py``: ``prefill_fast`` builds
the KV or SSM cache in one pass, and ``decode_step`` advances every
sequence one token, across the three cache families: dense GQA
(OLMo-1B's smoke config), the sliding-window ring with MoE (Mixtral's)
and the O(1) SSM state (Mamba2's), sampled at temperature 0.8.  The
prompt is 32 tokens, where the reference's example has 24: the chunked
SSD prefill needs a prompt that is a multiple of the chunk (16 in
Mamba2's smoke config) or shorter than it, so the reference's example
stops at its Mamba2 model (``AssertionError: seq 24 % chunk 16 != 0``).

  PYTHONPATH=src python examples/torch_serve_batched.py [--device cpu]
"""
import argparse
import time

import torch

from repro_torch import resolve_device
from repro_torch.configs.registry import get_smoke_config
from repro_torch.models import make_model
from repro_torch.serve.serving import generate

KINDS = {"olmo-1b": "dense KV cache",
         "mixtral-8x7b": "sliding-window ring cache + MoE",
         "mamba2-1.3b": "O(1) SSM state"}


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt", type=int, default=32)
    ap.add_argument("--new", type=int, default=24)
    args = ap.parse_args(argv)
    device = resolve_device(args.device)
    for arch, kind in KINDS.items():
        cfg = get_smoke_config(arch).model
        model = make_model(cfg)
        params = model.init(torch.Generator(device=device).manual_seed(0),
                            device=device)
        prompts = torch.randint(
            0, cfg.vocab, (args.batch, args.prompt), device=device,
            generator=torch.Generator(device=device).manual_seed(1))
        t0 = time.perf_counter()
        out = generate(model, params, prompts, args.new, temperature=0.8,
                       generator=torch.Generator(device=device).manual_seed(2))
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        dt = time.perf_counter() - t0
        print(f"{arch:14s} [{kind}] -> {tuple(out.shape)}, "
              f"{args.batch * args.new / dt:6.1f} tok/s")
        assert out.shape == (args.batch, args.prompt + args.new)
    print("served all three cache families")


if __name__ == "__main__":
    main()
