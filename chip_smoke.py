#!/usr/bin/env python3
"""Smoke run of the PyTorch port (``src/repro_torch``) on one NVIDIA GPU.

    python3 chip_smoke.py              # build, check, train, report
    python3 chip_smoke.py --profile    # also profile one round into
                                       # chiprun_out/round_profile.txt

It builds the port's CUDA kernels from ``src/repro_torch/kernels/csrc`` and
then, with TF32 off for convolutions and matmuls:

1. holds each kernel against its plain PyTorch version on the card, at the
   main path's shape and at a ragged one, bit for bit, and times the
   kernel, the plain version and (where one exists) the single PyTorch call
   that computes the same function;
2. trains PD-SGDM on the kernel layout through the port's entry points
   (``make_optimizer`` → ``SimTrainer.train``): ResNet-20 at width 16,
   K = 8 workers on a ring, batch 16 per worker, p = 4, η = 0.1, μ = 0.9,
   weight decay 1e-4, 14 steps (3 rounds and a 2-step tail), counting each
   kernel's launches in that run;
3. holds one kernel-path round against one tree-path round (no kernels)
   from the same init on the same batches.

Printed, in order: the card's ``nvidia-smi`` name and power limit, the build
time, the kernel phase, the training phase, the round parity, one JSON line
``{"kernels": [...]}`` and, last, ``{"ok": true, "device": {...}}``.  Any
failure raises and exits non-zero; so does a machine without a CUDA device.
Imports nothing of JAX or of the JAX package.
"""
from __future__ import annotations

import argparse
import json
import math
import os
import statistics
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.abspath(__file__))

# HBM bytes/s and f32 (non-tensor-core) FLOP/s by card name, from NVIDIA's
# data sheets (dense, at the card's full power limit); first match wins.
PEAKS = (
    ("H200", 4.8e12, 67e12),
    ("H100 NVL", 3.9e12, 60e12),
    ("H100 PCIe", 2.0e12, 51e12),
    ("H100", 3.35e12, 67e12),           # SXM5, 80 GB HBM3
)

DEVICE = "cuda"
K, WIDTH, BATCH, P, STEPS = 8, 16, 16, 4, 14
HYPER = dict(eta=0.1, mu=0.9, p=P, weight_decay=1e-4)
WIRE_BYTES = 2_539_520      # per worker per round: 2 × 310 rows × 1024 × 4 B
SPIN_CYCLES = 2_000_000     # about 1 ms at the H100's 1.98 GHz boost clock


def peaks(name: str):
    for key, bw, f32 in PEAKS:
        if key in name:
            return bw, f32
    raise RuntimeError(f"no HBM/f32 peak on record for {name!r}")


def time_ms(torch, fn, reps: int = 30, warmup: int = 5) -> float:
    """Median device time of ``fn`` over ``reps`` calls, each between its
    own CUDA events.  A spin kernel of about 1 ms runs ahead of each pair, so
    the device is still busy while the host enqueues the events and ``fn``'s
    launches: the interval holds device time, not launch overhead.  The L2
    cache is not flushed."""
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(SPIN_CYCLES)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def max_ulp(torch, a, b) -> int:
    """Largest distance between two f32 tensors in units in the last place."""
    ia = a.view(torch.int32).to(torch.int64)
    ib = b.view(torch.int32).to(torch.int64)
    ia = torch.where(ia < 0, -(ia & 0x7FFFFFFF), ia)
    ib = torch.where(ib < 0, -(ib & 0x7FFFFFFF), ib)
    return int((ia - ib).abs().max())


def kernel_phase(torch, ops, bw, f32_peak):
    """Each kernel against its plain version, bit for bit, and its times."""
    from repro_torch.core import ring
    from repro_torch.kernels.gossip_mix import gossip_mix
    from repro_torch.kernels.momentum import momentum_update
    from repro_torch.kernels.ref import gossip_mix_ref, momentum_update_ref
    LANE = ops.LANE
    dev = torch.device(DEVICE)
    gen = torch.Generator(device=dev).manual_seed(1234)
    mu, wd = HYPER["mu"], HYPER["weight_decay"]
    lr = torch.full((), HYPER["eta"], dtype=torch.float32, device=dev)
    ring_w = tuple(w for (_ax, _sh, w) in ring(K).shifts)
    main_rows = K * 512                  # (K, rows, 1024) folded onto rows
    results = {}
    for rows in (main_rows, 333):
        x, m, g = (torch.randn((rows, LANE), generator=gen, device=dev)
                   for _ in range(3))
        for nesterov in (False, True):
            got = momentum_update(x, m, g, lr, mu=mu, wd=wd, nesterov=nesterov)
            want = momentum_update_ref(x, m, g, lr, mu=mu, wd=wd,
                                       nesterov=nesterov)
            torch.cuda.synchronize()
            err = max(float((a - b).abs().max()) for a, b in zip(got, want))
            ulp = max(max_ulp(torch, a, b) for a, b in zip(got, want))
            print(f"kernel momentum_update rows={rows} nesterov={nesterov}: "
                  f"max_abs_err={err} max_ulp={ulp}")
            if not all(torch.equal(a, b) for a, b in zip(got, want)):
                raise AssertionError("momentum_update differs from its plain "
                                     f"version at rows={rows}")
            r = results.setdefault("momentum_update", [0.0, 0])
            r[0], r[1] = max(r[0], err), max(r[1], ulp)
        y = gossip_mix([x, m, g], weights=ring_w)
        want = gossip_mix_ref([x, m, g], ring_w)
        torch.cuda.synchronize()
        err, ulp = float((y - want).abs().max()), max_ulp(torch, y, want)
        print(f"kernel gossip_mix rows={rows} n=3: max_abs_err={err} "
              f"max_ulp={ulp}")
        if not torch.equal(y, want):
            raise AssertionError(f"gossip_mix differs from its plain version "
                                 f"at rows={rows}")
        r = results.setdefault("gossip_mix", [0.0, 0])
        r[0], r[1] = max(r[0], err), max(r[1], ulp)
    # every other input count the kernel is instantiated for (the ring and
    # the torus axes use 3 and 2; 1 and up to 8 are legal)
    xs = [torch.randn((333, LANE), generator=gen, device=dev)
          for _ in range(8)]
    for n in (1, 2, 4, 5, 6, 7, 8):
        ws = tuple(0.1 + 0.05 * j for j in range(n))
        if not torch.equal(gossip_mix(xs[:n], weights=ws),
                           gossip_mix_ref(xs[:n], ws)):
            raise AssertionError(f"gossip_mix differs at n={n}")
    print("kernel gossip_mix rows=333 n=1,2,4..8: bit-exact")

    # times at the main path's shape and configuration
    x, m, g = (torch.randn((main_rows, LANE), generator=gen, device=dev)
               for _ in range(3))
    n = x.numel()
    xs, ms, gs = x.clone(), m.clone(), g.clone()
    timings = {
        "momentum_update": dict(
            ms=time_ms(torch, lambda: momentum_update(x, m, g, lr, mu=mu,
                                                      wd=wd)),
            plain_ms=time_ms(torch, lambda: momentum_update_ref(x, m, g, lr,
                                                                mu=mu, wd=wd)),
            # the op behind torch.optim.SGD(fused=True): same update, in place
            library_ms=time_ms(torch, lambda: torch._fused_sgd_(
                [xs], [gs], [ms], weight_decay=wd, momentum=mu,
                lr=HYPER["eta"], dampening=0.0, nesterov=False,
                maximize=False, is_first_step=False)),
            bytes=5 * 4 * n, flops=6 * n),
        "gossip_mix": dict(
            ms=time_ms(torch, lambda: gossip_mix([x, m, g], weights=ring_w)),
            plain_ms=time_ms(torch, lambda: gossip_mix_ref([x, m, g], ring_w)),
            library_ms=None,
            bytes=4 * 4 * n, flops=5 * n),
    }
    for name, t in timings.items():
        by_bytes, by_ops = t["bytes"] / bw * 1e3, t["flops"] / f32_peak * 1e3
        t["bound_ms"] = max(by_bytes, by_ops)
        t["bound_by"] = "bytes" if by_bytes >= by_ops else "operations"
        t["max_abs_err"], t["max_ulp"] = results[name]
        print(f"kernel {name} ({main_rows}, {LANE}) f32: kernel_ms={t['ms']:.4f} "
              f"bound_ms={t['bound_ms']:.4f} ({t['bound_by']}) "
              f"plain_ms={t['plain_ms']:.4f} library_ms={t['library_ms']}")
    return timings


def stacked_init(torch, seed: int):
    from repro_torch.models.resnet import resnet20_init
    gen = torch.Generator(device=DEVICE).manual_seed(seed)
    params = resnet20_init(gen, width=WIDTH, device=DEVICE)
    return {k: v.unsqueeze(0).repeat((K,) + (1,) * v.dim())
            for k, v in params.items()}


def batch_fn(seed: int):
    from repro_torch.data.synthetic import ClassStreamCfg, class_batch
    cfg = ClassStreamCfg(batch=BATCH, n_workers=K, seed=seed)
    return lambda t: class_batch(cfg, t, DEVICE)


def trainer_for(use_kernel: bool):
    from repro_torch.core import DenseComm, make_optimizer, ring
    from repro_torch.models.resnet import resnet20_loss
    from repro_torch.train.trainer import SimTrainer
    opt = make_optimizer("pd_sgdm", DenseComm(ring(K), device=DEVICE),
                         use_kernel=use_kernel, **HYPER)
    return SimTrainer(resnet20_loss, opt, device=DEVICE)


def training_phase(torch):
    """The main path, once, with every launch counter set to 0 just before."""
    from repro_torch.kernels.gossip_mix import gossip_mix
    from repro_torch.kernels.momentum import momentum_update
    trainer = trainer_for(use_kernel=True)
    params = stacked_init(torch, 0)
    trainer.train(params, batch_fn(0), P)          # warm-up round, not timed
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    momentum_update.launches = 0
    gossip_mix.launches = 0
    t0 = time.perf_counter()
    out, state, hist = trainer.train(params, batch_fn(0), STEPS, log_every=1)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = {"momentum_update": momentum_update.launches,
                "gossip_mix": gossip_mix.launches}
    print(f"train: pd_sgdm kernel path, ResNet-20 width {WIDTH}, K={K} ring, "
          f"batch {BATCH}, p={P}, {STEPS} steps")
    print("train: losses " + " ".join(f"{v:.4f}" for v in hist.loss))
    print(f"train: {seconds:.3f} s for {STEPS} steps, "
          f"{seconds * P / STEPS:.4f} s per round, "
          f"peak memory {torch.cuda.max_memory_allocated() / 2**20:.1f} MiB")
    print(f"train: launches {launches}, comm_mb {hist.comm_mb[-1]}")
    if not all(math.isfinite(v) for v in hist.loss) or len(hist.loss) != STEPS:
        raise AssertionError(f"bad losses {hist.loss}")
    if launches != {"momentum_update": STEPS, "gossip_mix": STEPS // P}:
        raise AssertionError(f"main path launches {launches}, expected "
                             f"{STEPS} momentum and {STEPS // P} gossip")
    if hist.comm_mb[-1] != (STEPS // P) * WIRE_BYTES / 2 ** 20:
        raise AssertionError(f"comm_mb {hist.comm_mb[-1]}")
    if int(state["step"]) != STEPS:
        raise AssertionError(f"step counter {int(state['step'])}")
    for name, v in out.items():
        if v.shape != params[name].shape or not bool(torch.isfinite(v).all()):
            raise AssertionError(f"bad final param {name}")
    return launches


def parity_phase(torch):
    """One kernel-path round against one tree-path round (no kernels), with
    cuDNN held to deterministic algorithms so both rounds see the same
    gradients and differ only in how the gossip sums."""
    torch.backends.cudnn.deterministic = True
    params = stacked_init(torch, 1)
    got, _, hk = trainer_for(True).train(params, batch_fn(1), P, log_every=1)
    want, _, ht = trainer_for(False).train(params, batch_fn(1), P, log_every=1)
    torch.cuda.synchronize()
    worst = max(float((got[k] - want[k]).abs().max()) for k in want)
    print(f"parity: one round, kernel vs tree path: max |Δparam| = {worst}, "
          f"losses {hk.loss} vs {ht.loss}")
    for k in want:
        if not torch.allclose(got[k], want[k], rtol=1e-3, atol=1e-4):
            raise AssertionError(f"kernel round differs from tree round: {k}")
    torch.backends.cudnn.deterministic = False


def profile_round(torch):
    """Profile one steady-state round; the table goes to chiprun_out/."""
    from torch.profiler import ProfilerActivity, profile
    trainer = trainer_for(use_kernel=True)
    params = stacked_init(torch, 0)
    trainer.train(params, batch_fn(0), P)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        trainer.train(params, batch_fn(0), P)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    from torch.autograd import DeviceType
    events = prof.key_averages()
    kernels = [e for e in events if e.device_type == DeviceType.CUDA]

    def dev_us(e):
        return (getattr(e, "self_device_time_total", None)
                or getattr(e, "self_cuda_time_total", 0))

    busy = sum(dev_us(e) for e in kernels) / 1e6
    sort_key = ("self_device_time_total"
                if hasattr(events[0], "self_device_time_total")
                else "self_cuda_time_total")
    out_dir = os.path.join(ROOT, "chiprun_out")
    os.makedirs(out_dir, exist_ok=True)
    with open(os.path.join(out_dir, "round_profile.txt"), "w") as f:
        f.write(events.table(sort_by=sort_key, row_limit=60))
    print(f"profile: one round {wall * 1e3:.2f} ms wall under the profiler, "
          f"kernels {busy * 1e3:.2f} ms on the device")
    for e in sorted(kernels, key=dev_us, reverse=True)[:15]:
        print(f"profile:   {dev_us(e) / 1e3:9.3f} ms  x{e.count:<5d} "
              f"{e.key[:90]}")
    for name in ("momentum_kernel", "gossip_mix_kernel"):
        hits = [e for e in kernels if name in e.key]
        print(f"profile:   {name}: " + ", ".join(
            f"{dev_us(e) / e.count:.2f} us x{e.count}" for e in hits))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--profile", action="store_true",
                    help="also profile one round into chiprun_out/")
    args = ap.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this check "
              "needs an NVIDIA GPU", file=sys.stderr)
        return 1
    sys.path.insert(0, os.path.join(ROOT, "src"))
    from repro_torch.kernels import build, ops

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, check=True,
        timeout=60).stdout.strip().splitlines()[0]
    print(smi)
    bw, f32_peak = peaks(torch.cuda.get_device_name(0))

    t0 = time.perf_counter()
    logs = build.build()
    print(f"build: {time.perf_counter() - t0:.2f} s, nvcc for "
          f"{', '.join(sorted(logs)) or 'nothing (cached)'}")
    for name, log in sorted(logs.items()):
        for line in log.splitlines():
            if "registers" in line or "spill" in line:
                print(f"build: {name}: {line.strip()}")

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False

    timings = kernel_phase(torch, ops, bw, f32_peak)
    launches = training_phase(torch)
    parity_phase(torch)
    if args.profile:
        profile_round(torch)

    sources = {"momentum_update": ("momentum.cu", "momentum.py:56"),
               "gossip_mix": ("gossip_mix.cu", "gossip_mix.py:43")}
    kernels = []
    for name, t in timings.items():
        src, tpu = sources[name]
        kernels.append({
            "name": name, "route": "cuda",
            "source": f"src/repro_torch/kernels/csrc/{src}",
            "replaces": f"src/repro/kernels/{tpu}",
            "launches": launches[name], "max_abs_err": t["max_abs_err"],
            "max_ulp": t["max_ulp"], "ms": t["ms"], "plain_ms": t["plain_ms"],
            "bound_ms": t["bound_ms"], "bound_by": t["bound_by"],
            "library_ms": t["library_ms"]})
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
