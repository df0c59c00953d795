"""The round-contract driver: the reference's grids, each combination run
for one round and checked.

Port of ``src/repro/analysis/run.py``.

    python -m repro_torch.analysis.run                  # fast grid, CPU
    python -m repro_torch.analysis.run --grid full      # optimizer × codec
                                                        # × schedule sweep
    python -m repro_torch.analysis.run --phase dense --device cuda

Phases (each combination runs one warm round, then the checked one):

1. dense    — optimizer × {tree, kernel} on ``DenseComm`` (K = 8): p
              steps, no collective, no host sync, no f64, the kernel
              layout flattened once; the schedules, the hierarchical
              graphs and the membership script (``:40-144``).  With
              ``--device cuda`` the checked round runs under
              ``torch.cuda.set_sync_debug_mode("error")`` and each line
              names the kernels it launched.
2. sharded  — ``build_train`` on the tiny dense model of ``:177-196`` over a
              ``fake`` process group of 8 ranks × a model axis of 1,
              checked from rank 0's view: the exchange at the boundary,
              the sends' count, the momentum launch in place, the
              collective allowlist, accounted ≡ shipped bytes
              (``:147-302``).  On the CPU whatever ``--device`` says: on
              a fake group no payload moves.
3. retrace  — a full schedule sweep and a mid-cycle resume run one op
              program (``:305-311``).

Combinations the port refuses (as the reference does) are printed as
skipped.  Exit 0: the contract holds; 1: a violation (printed per
combination).
"""
from __future__ import annotations

import argparse
import contextlib
import sys
import time

__all__ = ["fake_group", "main", "phase_dense", "phase_retrace",
           "phase_sharded"]

K = 8


def _dense_grid(full: bool):
    # (optimizer, codec, use_kernel, overlap)
    grid = [
        ("pd_sgdm", None, False, False),
        ("pd_sgdm", None, True, False),
        ("cpd_sgdm", "sign", True, False),
        ("cpd_sgdm", "qsgd", False, False),
        ("cpd_sgdm", "sparse", True, False),
        ("mt_dsgdm", None, False, False),
        ("pd_sgdm", None, False, True),
        ("mt_dsgdm", None, True, True),
    ]
    if full:
        grid += [
            ("cpd_sgdm", "sign", False, False),
            ("cpd_sgdm", "qsgd", True, False),
            ("cpd_sgdm", "topk", False, False),
            ("cpd_sgdm", "randk", False, False),
            ("cpd_sgdm", "identity", False, False),
            ("cpd_sgdm", "sparse+sign", False, False),
            ("qg_dsgdm", None, False, False),
            ("mt_dsgdm", None, True, False),
            ("pd_sgdm", None, True, True),
            ("mt_dsgdm", None, False, True),
            ("qg_dsgdm", None, True, True),
            ("cpd_sgdm", "sign", False, True),
        ]
    return grid


def _launched(before: dict) -> str:
    from repro_torch.analysis.round_check import kernel_launches
    now = kernel_launches()
    got = {n: now[n] - before[n] for n in now if now[n] != before[n]}
    return ", ".join(f"{n} {c}" for n, c in got.items()) or "no kernel"


def _dense_one(label, opt, params, failures, device, **kw):
    from repro_torch.analysis import round_check as rc
    before = rc.kernel_launches()
    v = rc.check_round_contract(opt, params, sync_debug=device == "cuda",
                                **kw)
    _report(label, v, failures,
            f"launched {_launched(before)}" if device == "cuda" else "")


def phase_dense(full: bool, device: str = "cpu") -> list:
    from repro_torch.analysis import round_check as rc
    from repro_torch.core import make_compressor, make_optimizer
    from repro_torch.core.gossip import DenseComm
    from repro_torch.core.topology import (hierarchical,
                                           hierarchical_schedule,
                                           make_schedule, ring)
    from repro_torch.testing import chaos_script, membership_for

    params = rc.toy_params(K, device=device)
    failures = []
    for name, comp, kernel, overlap in _dense_grid(full):
        opt = make_optimizer(name, DenseComm(ring(K), device=device),
                             eta=0.05, mu=0.9, p=3,
                             compressor=make_compressor(comp) if comp
                             else None, use_kernel=kernel, overlap=overlap)
        kern = kernel and opt.kernel_comm_supported
        label = (f"dense/{name}/{comp or 'none'}/"
                 f"{'kernel' if kern else 'tree'}"
                 + ("/overlap" if overlap else ""))
        _dense_one(label, opt, params, failures, device, kernel=kernel)

    # scheduled rounds: round r's matrix chosen on the device
    for sched_name in (["one_peer_exp"] if not full else
                       ["one_peer_exp", "random_matching"]):
        sched = make_schedule(sched_name, (K,))
        opt = make_optimizer("pd_sgdm", DenseComm(sched, device=device),
                             eta=0.05, mu=0.9, p=2)
        _dense_one(f"dense/pd_sgdm/{sched_name}", opt, params, failures,
                   device, schedule_period=sched.period)

    # hierarchical two-level rounds in their factored form
    hier_grid = [("pd_sgdm", False, False), ("pd_sgdm", True, False)]
    if full:
        hier_grid += [("mt_dsgdm", False, False), ("pd_sgdm", False, True),
                      ("mt_dsgdm", True, True)]
    for name, kernel, overlap in hier_grid:
        opt = make_optimizer(name, DenseComm(hierarchical(2, 4),
                                             device=device),
                             eta=0.05, mu=0.9, p=3, use_kernel=kernel,
                             overlap=overlap)
        kern = kernel and opt.kernel_comm_supported
        _dense_one(f"dense/{name}/hier-m4/{'kernel' if kern else 'tree'}"
                   + ("/overlap" if overlap else ""), opt, params, failures,
                   device, kernel=kernel)
    sched = hierarchical_schedule(4, 2)
    opt = make_optimizer("pd_sgdm", DenseComm(sched, device=device),
                         eta=0.05, mu=0.9, p=2)
    _dense_one("dense/pd_sgdm/hier_one_peer", opt, params, failures, device,
               schedule_period=sched.period)

    # elastic membership: the masked matrices every round of the cycle
    ms = membership_for(K, 6, chaos_script(K, 6, seed=7))
    for name, comp, overlap in (
            [("pd_sgdm", None, False), ("pd_sgdm", None, True)] if not full
            else [("pd_sgdm", None, False), ("cpd_sgdm", "sign", False),
                  ("mt_dsgdm", None, False), ("pd_sgdm", None, True),
                  ("mt_dsgdm", None, True)]):
        opt = make_optimizer(name, DenseComm(ring(K), membership=ms,
                                             device=device),
                             eta=0.05, mu=0.9, p=3,
                             compressor=make_compressor(comp) if comp
                             else None, overlap=overlap)
        _dense_one(f"dense/{name}/{comp or 'none'}/membership"
                   + ("/overlap" if overlap else ""), opt, params, failures,
                   device)
    opt = make_optimizer("pd_sgdm", DenseComm(hierarchical(2, 4),
                                              membership=ms, device=device),
                         eta=0.05, mu=0.9, p=3)
    _dense_one("dense/pd_sgdm/hier-m4/membership", opt, params, failures,
               device)
    return failures


# ------------------------------------------------------------------ sharded
@contextlib.contextmanager
def fake_group(world: int, rank: int = 0):
    """A ``fake`` process group of ``world`` ranks with this process as
    ``rank``: collectives of CPU tensors return at once and move nothing
    (a meta payload is counted by the recorder and never posted).  The
    group is destroyed on exit."""
    import torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore
    if dist.is_initialized():
        raise RuntimeError("a process group is already initialized")
    dist.init_process_group("fake", store=FakeStore(), rank=rank,
                            world_size=world)
    try:
        yield
    finally:
        dist.destroy_process_group()


def tiny_run(opt_name, codec, use_kernel, schedule, overlap=False,
             node_size=0, wire_dtype="float32", inter_codec="none"):
    """The reference's sharded check model (``run.py:177-196``) in a
    ``RunCfg``."""
    from repro_torch.configs.base import ModelCfg, OptimCfg, ParallelCfg, \
        RunCfg
    mcfg = ModelCfg(name="tiny", arch_type="dense", n_layers=2, d_model=32,
                    n_heads=4, n_kv_heads=2, d_ff=64, vocab=128)
    return RunCfg(model=mcfg,
                  parallel=ParallelCfg(profile="A", remat="none",
                                       topology_schedule=schedule,
                                       node_size=node_size,
                                       inter_codec=inter_codec),
                  optim=OptimCfg(name=opt_name, p=2, compressor=codec,
                                 use_kernel=use_kernel, overlap=overlap,
                                 wire_dtype=wire_dtype))


def round_batches(pack, p: int, batch: int = 1, seq: int = 16, seed: int = 0,
                  device="cpu") -> dict:
    """One round of this rank's batches, ``(p, 1, batch, seq)``."""
    import torch
    from repro_torch.configs.shapes import train_batch_arrays
    gen = torch.Generator().manual_seed(seed)
    steps = [train_batch_arrays(pack.model.cfg, 1, batch, seq, gen,
                                device=device) for _ in range(p)]
    return {k: torch.stack([s[k] for s in steps]) for k in steps[0]}


def check_sharded_pack(pack, *, expected: int = None, schedule="static",
                       overlap=False, device="cpu", rounds: int = 1
                       ) -> list:
    """Every check on ``rounds`` executed rounds of ``pack`` (after a warm
    one) from this rank's view; ``expected`` pins the sends a round."""
    from repro_torch.analysis import round_check as rc
    from repro_torch.analysis import wire_check as wc
    from repro_torch.launch.runtime import make_steps
    p = pack.opt.config.p
    from repro_torch.analysis.collectives import CommRecorder
    mesh = pack.layout.mesh
    params, state = pack.init_fn(0)
    batches = round_batches(pack, p, device=device)
    with CommRecorder(mesh, loopback=True):
        params, state, _ = pack.train_round(params, state, batches, 0)
    v, peers = [], []
    for i in range(rounds):
        launches = []

        def round_fn(pr, st, gf, b, t=(i + 1) * p):
            _, train_round = make_steps(pack.opt, gf)
            return train_round(pr, st, b, t)

        with wc.watch_momentum(launches):
            rec = rc.trace_round(pack.opt, params, state, batches,
                                 round_fn=round_fn, grads_fn=pack.grad_fn,
                                 mesh=mesh, loopback=True)
        params, state = rec.out[0], rec.out[1]
        peers.append(tuple(sorted(c.peer for c in rec.calls
                                  if c.op == "collective-permute")))
        if i:
            continue
        v += rc.check_no_host_sync(rec)
        v += rc.check_round_steps(rec, p)
        if overlap:
            v += rc.check_overlap_boundary(rec, p, expected=expected)
        else:
            v += rc.check_gossip_boundary(rec, p, expected=expected)
        v += rc.check_no_f64(rec)
        if pack.opt.config.use_kernel:
            v += rc.check_kernel_flatten_once(rec, p)
        v += wc.check_sharded_round(pack, rec.calls, launches,
                                    check_bytes=schedule == "static")
    if schedule != "static" and len(set(peers)) != rounds:
        v.append(f"schedule of period {rounds}: {len(set(peers))} distinct "
                 f"exchange patterns over one period ({peers})")
    return v


def _sharded_grid(full: bool):
    # (optimizer, codec, use_kernel, topology_schedule, overlap)
    grid = [
        ("pd_sgdm", "sign", False, "static", False),
        ("pd_sgdm", "sign", True, "static", False),
        ("cpd_sgdm", "sign", False, "static", False),
        ("cpd_sgdm", "sparse", True, "static", False),
        ("pd_sgdm", "sign", False, "one_peer_exp", False),
        ("pd_sgdm", "sign", False, "static", True),
        ("pd_sgdm", "sign", True, "static", True),
    ]
    if full:
        grid += [
            ("cpd_sgdm", "sign", True, "static", False),
            ("cpd_sgdm", "qsgd", False, "static", False),
            ("cpd_sgdm", "topk", False, "static", False),
            ("cpd_sgdm", "randk", False, "static", False),
            ("cpd_sgdm", "sparse+qsgd", False, "static", False),
            ("mt_dsgdm", "sign", False, "static", False),
            ("pd_sgdm", "sign", False, "random_matching", False),
            ("pd_sgdm", "sign", True, "one_peer_exp", False),
            ("mt_dsgdm", "sign", False, "static", True),
            ("mt_dsgdm", "sign", True, "static", True),
            ("qg_dsgdm", "sign", False, "static", True),
            ("pd_sgdm", "sign", False, "one_peer_exp", True),
            ("cpd_sgdm", "sign", False, "static", True),   # must skip
        ]
    return grid


def _hier_grid(full: bool):
    # (optimizer, use_kernel, schedule, overlap, wire_dtype, inter_codec)
    grid = [
        ("pd_sgdm", False, "static", False, "float32", "none"),
        ("pd_sgdm", True, "static", False, "float32", "none"),
        ("pd_sgdm", False, "static", False, "bfloat16", "none"),
    ]
    if full:
        grid += [
            ("mt_dsgdm", False, "static", False, "float32", "none"),
            ("pd_sgdm", True, "static", False, "bfloat16", "none"),
            ("pd_sgdm", False, "hier_one_peer", False, "float32", "none"),
            ("pd_sgdm", False, "static", True, "float32", "none"),
            ("pd_sgdm", True, "static", True, "float32", "none"),
            ("pd_sgdm", False, "static", False, "float32", "identity"),
            ("cpd_sgdm", False, "static", False, "float32", "none"),  # skip
        ]
    return grid


def _n_arrays(pack, use_kernel: bool) -> int:
    return (1 if use_kernel and pack.opt.kernel_comm_supported
            else len(pack.params_struct))


def phase_sharded(full: bool, device: str = "cpu") -> list:
    import torch
    from repro_torch.core.topology import hierarchical_inter_shifts
    from repro_torch.launch.mesh import make_mesh
    from repro_torch.launch.runtime import build_train

    failures = []
    with fake_group(K):
        mesh = make_mesh((K,), ("data",), device=torch.device(device))
        for opt_name, codec, kernel, schedule, overlap in _sharded_grid(full):
            label = (f"sharded/{opt_name}/{codec}/"
                     f"{'kernel' if kernel else 'tree'}/{schedule}"
                     + ("/overlap" if overlap else ""))
            try:
                pack = build_train(tiny_run(opt_name, codec, kernel,
                                            schedule, overlap), mesh)
            except ValueError as e:     # a combination the port refuses
                print(f"  skip {label}: {e}")
                continue
            expected = None
            if opt_name == "pd_sgdm" and schedule == "static":
                expected = (pack.opt.comm.topology.degree
                            * _n_arrays(pack, kernel))
            v = check_sharded_pack(pack, expected=expected,
                                   schedule=schedule, overlap=overlap,
                                   device=device,
                                   rounds=pack.opt.comm.period)
            _report(label, v, failures)

        for (opt_name, kernel, schedule, overlap, wdt,
             icodec) in _hier_grid(full):
            label = (f"sharded/{opt_name}/hier-m4/"
                     f"{'kernel' if kernel else 'tree'}/{schedule}"
                     + (f"/{wdt}" if wdt != "float32" else "")
                     + (f"/codec-{icodec}" if icodec != "none" else "")
                     + ("/overlap" if overlap else ""))
            try:
                pack = build_train(tiny_run(
                    opt_name, "sign", kernel, schedule, overlap, node_size=4,
                    wire_dtype=wdt, inter_codec=icodec), mesh)
            except ValueError as e:
                print(f"  skip {label}: {e}")
                continue
            expected = None
            if opt_name == "pd_sgdm" and schedule == "static":
                ideg = len(hierarchical_inter_shifts(pack.opt.comm.topology))
                expected = ideg * _n_arrays(pack, kernel)
            v = check_sharded_pack(pack, expected=expected,
                                   schedule=schedule, overlap=overlap,
                                   device=device,
                                   rounds=pack.opt.comm.period)
            _report(label, v, failures)
    return failures


def phase_retrace(device: str = "cpu") -> list:
    from repro_torch.analysis.retrace import check_schedule_no_retrace
    failures = []
    v = check_schedule_no_retrace(device=device)
    _report("retrace/one_peer_exp-sweep+resume", v, failures)
    return failures


def _report(label: str, violations: list, failures: list, note: str = ""):
    status = "ok" if not violations else "FAIL"
    print(f"  {status:4s} {label}" + (f"  ({note})" if note else ""))
    for msg in violations:
        print(f"       - {msg}")
    if violations:
        failures.append((label, violations))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description="round-contract checks")
    ap.add_argument("--grid", choices=("fast", "full"), default="fast")
    ap.add_argument("--phase", choices=("all", "dense", "sharded", "retrace"),
                    default="all")
    ap.add_argument("--device", choices=("cpu", "cuda"), default="cpu")
    args = ap.parse_args(argv)
    full = args.grid == "full"
    import torch
    torch.set_num_threads(1)
    if args.device == "cuda" and not torch.cuda.is_available():
        print("analysis: --device cuda needs a card", file=sys.stderr)
        return 2

    failures = []
    t0 = time.time()
    if args.phase in ("all", "dense"):
        print(f"[1/3] dense round contract grid ({args.device})")
        failures += phase_dense(full, args.device)
    if args.phase in ("all", "sharded"):
        print("[2/3] sharded round contract grid (fake group, 8 ranks)")
        failures += phase_sharded(full)
    if args.phase in ("all", "retrace"):
        print("[3/3] one op program across a schedule")
        failures += phase_retrace(args.device)
    dt = time.time() - t0
    if failures:
        print(f"\nround contract: {len(failures)} combination(s) violated "
              f"the contract ({dt:.0f}s)", file=sys.stderr)
        return 1
    print(f"\nround contract: holds ({dt:.0f}s)")
    return 0


if __name__ == "__main__":
    sys.exit(main())
