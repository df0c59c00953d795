"""Training launcher of the sharded runtime.

  PYTHONPATH=src python -m repro_torch.launch.train --arch olmo-1b --smoke \\
      --optimizer pd_sgdm --steps 50 --workers 4 --dist-backend gloo

Port of ``src/repro/launch/train.py``, with the reference's flags;
``--devices`` becomes ``--workers N``, and the mesh follows the arch's
profile as the reference's does.  Profile A: N workers on the
``"data"`` axis, each of ``--model-axis M`` ranks (tensor-parallel
inside it; 1 by default, one rank a worker).  Profile B: ``--workers N``
is the ``"pod"`` axis (the workers), ``--data-axis D`` the FSDP axis and
``--model-axis M`` the TP axis inside each worker (N = 1: no pod axis,
one worker).  Under ``torchrun`` every rank joins the process group from
the environment, and the world is N × D × M.  Without it, ``--workers
N`` spawns N × D × M ranks from this process (start method ``spawn``);
with ``--device cuda`` the parent builds the CUDA kernels first, so that
the ranks do not run nvcc at once.
``--dist-backend`` is ``nccl`` (one GPU per rank) or ``gloo`` (any host;
ranks that share one card all run on ``cuda:0``).  ``--smoke`` selects
the reduced config.  Rank 0 prints the log; every rank logs the same
global loss.
"""
from __future__ import annotations

import argparse
import dataclasses
import os
import sys

__all__ = ["main", "mesh_axes", "parse_args", "rank_main", "run_config"]


def parse_args(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--arch", required=True)
    ap.add_argument("--optimizer", default=None,
                    help="pd_sgdm|cpd_sgdm|choco_sgd|mt_dsgdm|qg_dsgdm|"
                         "c_sgdm|d_sgd|pd_sgd; cpd_sgdm and choco_sgd ship "
                         "the --compressor's payload, mt_dsgdm with "
                         "--track-compressed ships its correction through "
                         "it (both on a one-axis static graph: a ring or "
                         "an exponential graph)")
    ap.add_argument("--p", type=int, default=None)
    ap.add_argument("--eta", type=float, default=None)
    ap.add_argument("--topology", default=None,
                    help="ring|torus|complete|exponential|disconnected")
    ap.add_argument("--topology-schedule", default=None,
                    help="static|one_peer_exp|alt_axes|random_matching")
    ap.add_argument("--use-kernel", action="store_true",
                    help="run the fused round on the flatten-once kernel "
                         "layout (the CUDA kernels on a card, their plain "
                         "versions on the CPU)")
    ap.add_argument("--overlap", action="store_true",
                    help="overlapped rounds: round r's payload mixed one "
                         "round late")
    ap.add_argument("--node-size", type=int, default=None,
                    help="hierarchical two-level gossip over nodes of this "
                         "many workers, --topology between node leaders")
    ap.add_argument("--wire-dtype", default=None,
                    choices=("float32", "bfloat16"))
    ap.add_argument("--inter-codec", default=None,
                    help="compress the hierarchical inter wire "
                         "(identity|sign|topk|qsgd; needs --node-size)")
    ap.add_argument("--compressor", default=None)
    ap.add_argument("--compressor-fraction", type=float, default=None)
    ap.add_argument("--compressor-levels", type=int, default=None)
    ap.add_argument("--compressor-block", type=int, default=None)
    ap.add_argument("--compressor-rows", type=int, default=None)
    ap.add_argument("--track-compressed", action="store_true")
    ap.add_argument("--steps", type=int, default=50)
    ap.add_argument("--seq-len", type=int, default=64)
    ap.add_argument("--global-batch", type=int, default=16)
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--workers", type=int, default=0,
                    help="spawn this many workers (--data-axis × "
                         "--model-axis ranks each) when not under torchrun")
    ap.add_argument("--model-axis", type=int, default=1,
                    help="the TP axis: ranks a worker's params split over")
    ap.add_argument("--data-axis", type=int, default=1,
                    help="profile B's FSDP axis inside each worker (the "
                         "worker's params and batch split over it)")
    ap.add_argument("--dist-backend", default="gloo", choices=("nccl",
                                                               "gloo"))
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--ckpt-dir", default=None)
    ap.add_argument("--ckpt-every", type=int, default=0)
    ap.add_argument("--resume", action="store_true",
                    help="continue from the latest checkpoint in --ckpt-dir")
    return ap.parse_args(argv)


def run_config(args):
    """The ``RunCfg`` of the flags."""
    from repro_torch.configs.registry import get_config, get_smoke_config
    run = (get_smoke_config if args.smoke else get_config)(args.arch)
    o = run.optim
    for field, val in (("name", args.optimizer), ("p", args.p),
                       ("eta", args.eta), ("compressor", args.compressor),
                       ("compressor_fraction", args.compressor_fraction),
                       ("compressor_levels", args.compressor_levels),
                       ("compressor_block", args.compressor_block),
                       ("compressor_rows", args.compressor_rows),
                       ("wire_dtype", args.wire_dtype)):
        if val is not None:
            o = dataclasses.replace(o, **{field: val})
    for flag, field in ((args.use_kernel, "use_kernel"),
                        (args.overlap, "overlap"),
                        (args.track_compressed, "track_compressed")):
        if flag:
            o = dataclasses.replace(o, **{field: True})
    par = run.parallel
    for field, val in (("topology", args.topology),
                       ("topology_schedule", args.topology_schedule),
                       ("node_size", args.node_size),
                       ("inter_codec", args.inter_codec)):
        if val is not None:
            par = dataclasses.replace(par, **{field: val})
    return dataclasses.replace(run, optim=o, parallel=par)


def mesh_axes(run, world: int, args):
    """``(axis_sizes, axis_names)`` of the mesh (the model axis apart):
    profile A's workers on ``"data"``; profile B's on ``"pod"`` (none for
    one worker) beside the FSDP ``"data"`` axis."""
    d, m = args.data_axis, args.model_axis
    if world % (d * m):
        raise SystemExit(f"{world} ranks do not split into workers of "
                         f"--data-axis {d} × --model-axis {m}")
    n = world // (d * m)
    if run.parallel.profile != "B":
        if d != 1:
            raise SystemExit(f"--data-axis {d}: the FSDP axis is profile "
                             f"B's; {args.arch} is profile "
                             f"{run.parallel.profile!r}")
        return (n,), ("data",)
    if n == 1:
        return (d,), ("data",)
    return ((n, d), ("pod", "data")) if d > 1 else ((n,), ("pod",))


def rank_main(mesh_rank, args) -> dict:
    """One rank's run: the mesh, ``build_train``, ``ShardedTrainer``.
    Returns the history (every rank's is the same)."""
    from repro_torch.configs.shapes import train_batch_arrays
    from repro_torch.data.synthetic import _generator
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.launch.runtime import build_train
    from repro_torch.train.trainer import ShardedTrainer

    rank, world, device = mesh_rank
    run = run_config(args)
    mesh = make_mesh(*mesh_axes(run, world, args), device=device,
                     model_axis=args.model_axis)
    pack = build_train(run, mesh)
    K = pack.layout.n_workers
    o = run.optim
    verbose = rank == 0
    if verbose:
        print(f"arch={args.arch} optimizer={o.name} p={o.p} workers={K} "
              f"profile={run.parallel.profile} data_axis={args.data_axis} "
              f"model_axis={args.model_axis} kernel={o.use_kernel} "
              f"overlap={o.overlap} backend={args.dist_backend} "
              f"device={device}", flush=True)

    def batch_fn(t):
        return pack.worker_batch(train_batch_arrays(
            run.model, K, args.global_batch // K, args.seq_len,
            _generator(device, 1, t), device=device))

    trainer = ShardedTrainer(pack, ckpt_dir=args.ckpt_dir,
                             ckpt_every=args.ckpt_every)
    out = trainer.train(args.seed, batch_fn, args.steps,
                        log_every=max(args.steps // 10, 1), verbose=verbose,
                        resume=args.resume)
    h = out["history"]
    if verbose:
        if not h.loss:
            print("no steps run")
        else:
            print(f"final loss {h.loss[-1]:.4f} (start {h.loss[0]:.4f})")
            if out["steps_run"] == args.steps and h.loss[-1] >= h.loss[0]:
                print("WARNING: loss did not decrease", file=sys.stderr)
    return {"steps": h.steps, "loss": h.loss, "comm_mb": h.comm_mb,
            "steps_run": out["steps_run"]}


def main(argv=None):
    args = parse_args(argv)
    if "RANK" in os.environ:                 # under torchrun
        from repro_torch.launch.mesh import init_workers
        import torch.distributed as dist
        mesh_rank = init_workers(args.dist_backend, device=args.device)
        try:
            return rank_main(mesh_rank, args)
        finally:
            dist.destroy_process_group()
    if args.workers < 1:
        raise SystemExit("--workers N (N ≥ 1) is needed outside torchrun")
    if args.device == "cuda":
        from repro_torch.kernels import build
        build.build()
    from repro_torch.launch.spawn import spawn_ranks
    return spawn_ranks(rank_main,
                       args.workers * args.data_axis * args.model_axis,
                       (args,), backend=args.dist_backend,
                       device=args.device)[0]


if __name__ == "__main__":
    main()
