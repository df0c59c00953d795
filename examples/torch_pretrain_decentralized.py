"""End-to-end driver: decentralized LM pretraining on the port's sharded
runtime.

The port of ``examples/pretrain_decentralized.py``: an OLMo-family model
trained (PD-SGDM by default) by ``--workers`` workers of ``--model-axis``
ranks each (default 2, the reference's ``make_mesh((devices // 2, 2),
("data", "model"))``: 8 ranks for 4 workers, tensor-parallel inside each)
through ``build_train`` and ``ShardedTrainer``: fused p-step rounds,
gossip by P2P between the workers' ranks, checkpoints with the whole
optimizer state, so ``--resume`` continues bit for bit.  ``--optimizer`` takes any of the
launcher's (``cpd_sgdm`` and ``choco_sgd`` ship the default sign codec's
payload, each rank keeping a copy of each neighbour's x̂).
``--node-size m`` switches to the
two-level round (exact in-node mean, ``--topology`` between node
leaders), ``--wire-dtype bfloat16`` halves the inter wire and
``--inter-codec`` compresses it; ``--json-out`` writes the reference's
run record (loss endpoints, tokens/s, comm-MB, bytes per round: the
reference's per-worker figure, and ``bytes_per_rank``, what each rank
hands to ``isend``).

The default model has about 100M params (12 layers, d_model 768, vocab
32,768) at seq 256; ``--quick`` shrinks it to 4 layers, d_model 128,
vocab 4,096, seq 64, 30 steps at most.

  PYTHONPATH=src python examples/torch_pretrain_decentralized.py --quick
  PYTHONPATH=src python examples/torch_pretrain_decentralized.py \\
      --quick --node-size 2 --wire-dtype bfloat16 --device cpu
  PYTHONPATH=src python examples/torch_pretrain_decentralized.py \\
      --quick --model-axis 1 --device cpu       # one rank a worker
"""
import argparse
import json
import sys
import time


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workers", type=int, default=4)
    ap.add_argument("--model-axis", type=int, default=2,
                    help="ranks per worker, tensor-parallel inside it")
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--quick", action="store_true")
    ap.add_argument("--optimizer", default="pd_sgdm")
    ap.add_argument("--p", type=int, default=4)
    ap.add_argument("--topology", default="ring",
                    help="gossip graph between workers (flat), or between "
                         "node leaders when --node-size is set")
    ap.add_argument("--node-size", type=int, default=0,
                    help="two-level gossip: exact in-node averaging over "
                         "groups of this many workers (0 = flat)")
    ap.add_argument("--wire-dtype", default="float32",
                    choices=("float32", "bfloat16"))
    ap.add_argument("--inter-codec", default="none",
                    help="compress the hierarchical inter wire "
                         "(identity/sign/topk/qsgd; needs --node-size)")
    ap.add_argument("--json-out", default=None,
                    help="write the run record to this JSON file")
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--resume", action="store_true",
                    help="continue from the latest checkpoint in --ckpt-dir")
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    ap.add_argument("--dist-backend", default="gloo",
                    choices=("nccl", "gloo"))
    return ap.parse_args(argv)


def setup(args):
    """The model config, the run config, seq, global batch and steps."""
    from repro_torch.configs.base import (ModelCfg, OptimCfg, ParallelCfg,
                                          RunCfg)
    if args.quick:
        mcfg = ModelCfg(name="lm-5m", arch_type="dense", n_layers=4,
                        d_model=128, n_heads=4, n_kv_heads=2, d_ff=512,
                        vocab=4096)
        seq, gbatch, steps = 64, 16, min(args.steps, 30)
    else:
        mcfg = ModelCfg(name="lm-100m", arch_type="dense", n_layers=12,
                        d_model=768, n_heads=12, n_kv_heads=4, d_ff=3072,
                        vocab=32768)
        seq, gbatch, steps = 256, 16, args.steps
    run = RunCfg(model=mcfg,
                 parallel=ParallelCfg(profile="A", remat="none",
                                      topology=args.topology,
                                      node_size=args.node_size,
                                      inter_codec=args.inter_codec),
                 optim=OptimCfg(name=args.optimizer, eta=0.25, mu=0.9,
                                p=args.p, weight_decay=1e-4,
                                wire_dtype=args.wire_dtype))
    return mcfg, run, seq, gbatch, steps


def rank_main(mesh_rank, args) -> dict:
    """One rank: the mesh, ``build_train``, ``ShardedTrainer``."""
    from repro_torch.data.synthetic import LMStreamCfg, lm_batch
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.launch.runtime import build_train
    from repro_torch.train.trainer import ShardedTrainer

    rank, world, device = mesh_rank
    mcfg, run, seq, gbatch, steps = setup(args)
    mesh = make_mesh((args.workers,), ("data",), device=device,
                     model_axis=args.model_axis)
    pack = build_train(run, mesh)
    K = pack.layout.n_workers
    verbose = rank == 0
    if verbose:
        print(f"model={mcfg.name} params={mcfg.params_count() / 1e6:.1f}M "
              f"workers={K} model_axis={args.model_axis} "
              f"optimizer={run.optim.name} p={run.optim.p} "
              f"seq={seq} global_batch={gbatch} topology={args.topology} "
              f"node_size={args.node_size} wire_dtype={args.wire_dtype} "
              f"backend={args.dist_backend} device={device}", flush=True)
    data = LMStreamCfg(vocab=mcfg.vocab, seq_len=seq, batch=gbatch // K,
                       n_workers=K)
    trainer = ShardedTrainer(pack, ckpt_dir=args.ckpt_dir,
                             ckpt_every=100 if args.ckpt_dir else 0)
    wall0 = time.time()
    out = trainer.train(0, lambda t: pack.worker_batch(
        lm_batch(data, t, device)), steps, log_every=max(steps // 20, 1),
        verbose=verbose, resume=args.resume)
    elapsed = time.time() - wall0
    h = out["history"]
    return {"history": {"steps": h.steps, "loss": h.loss,
                        "comm_mb": h.comm_mb},
            "steps_run": out["steps_run"], "wall_s": elapsed,
            "bytes_per_comm_round": trainer.bytes_per_round(),
            "rank_bytes": trainer.rank_bytes_per_round_cycle()[0],
            "workers": K}


def main(argv=None) -> dict:
    args = parse_args(argv)
    mcfg, run, seq, gbatch, steps = setup(args)
    if args.device == "cuda":
        from repro_torch.kernels import build
        build.build()
    from repro_torch.launch.spawn import spawn_ranks
    ranks = spawn_ranks(rank_main, args.workers * args.model_axis, (args,),
                        backend=args.dist_backend, device=args.device)
    res = ranks[0]
    h = res["history"]
    if not h["loss"]:               # --resume with a checkpoint at/past --steps
        print("no steps run")
        return {}
    ran, elapsed = res["steps_run"], res["wall_s"]
    tokens_per_s = ran * gbatch * seq / max(elapsed, 1e-9)
    comm_mb = h["comm_mb"][-1] if h["comm_mb"] else 0.0
    print(f"loss: {h['loss'][0]:.4f} -> {h['loss'][-1]:.4f} over {ran} "
          f"steps ({tokens_per_s:.0f} tok/s, {comm_mb:.1f} "
          "comm-MB/worker)")
    record = {
        "model": mcfg.name, "params": mcfg.params_count(),
        "workers": res["workers"], "optimizer": run.optim.name,
        "p": run.optim.p, "topology": args.topology,
        "node_size": args.node_size, "wire_dtype": args.wire_dtype,
        "inter_codec": args.inter_codec, "steps": ran, "seq": seq,
        "global_batch": gbatch, "first_loss": h["loss"][0],
        "final_loss": h["loss"][-1], "tokens_per_s": tokens_per_s,
        "comm_mb": comm_mb,
        "bytes_per_comm_round": res["bytes_per_comm_round"],
        "model_axis": args.model_axis,
        "bytes_per_rank": [r["rank_bytes"] for r in ranks],
        "wall_s": elapsed,
    }
    if args.json_out:
        with open(args.json_out, "w") as f:
            json.dump(record, f, indent=1)
        print(f"wrote {args.json_out}")
    if ran == steps and not h["loss"][-1] < h["loss"][0]:
        # a short resumed tail is too noisy to judge
        print("training failed to reduce loss", file=sys.stderr)
        raise SystemExit(1)
    return record


if __name__ == "__main__":
    main()
