"""One run of a cell: set-up, the timed or the traced window, the check.

Set-up builds one object, the program (:class:`bench.program.Program`),
and drives it from x0 through its first rounds with the window's own call
(``SimTrainer.train``) and feed: one step, whose momentum gives the first
gradient as the optimizer got it (``m₁ = g₁ + wd·x0``), then the cell's
``check_rounds`` whole rounds from the same x0, whose losses, params and
optimizer state are read.  A warm call of a whole block of rounds, so
that the window maps no more device memory, and whose time sets how many
rounds fill the window; the window is one ``train`` call from where the
warm rounds ended, on batches staged before it.  Once the window has
closed, its peak memory has been read and the program's state is freed,
the plain reference follows the same first rounds from the same x0 on
the same batches, and :mod:`bench.judge` compares the two.
"""
from __future__ import annotations

import dataclasses
import gc
import importlib
import json
import math
import os
import subprocess
import tempfile
import time

import torch

from bench import judge, streams, tracing, weights, yardstick
from bench.program import Program
from bench.reference.common import Ops
from bench.reference.pd_sgdm import change_norms, leaf_norms
from bench.spec import ROOT, reader

TRACE_ROUNDS = 6
# SimTrainer.train at its default log_every (10) and p = 4 flushes every
# ceil(10 / 4) = 3 rounds; from a call's second round on, the caller's
# params, the last round's and the round's own matrices are alive at once
WARM_ROUNDS = 3


def _sync(device):
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


def free(device):
    gc.collect()
    if torch.device(device).type == "cuda":
        torch.cuda.empty_cache()


def f32_only():
    """The configurations state f32: no TF32 in products or convolutions."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


class Setup:
    """A cell's program, the reference beside it, and their shared
    shapes, x0 and token stream, all made from ``seed``."""

    def __init__(self, cell, seed: int, device):
        self.cell, self.seed, self.device = cell, seed, device
        t = cell.traffic
        self.model_ref = importlib.import_module(
            f"bench.reference.{cell.config['reference']}")
        self.round_ref = importlib.import_module(
            f"bench.reference.{t['reference']}")
        self.shapes = self.model_ref.param_shapes(cell.model)
        self.prog = Program(cell.model, t, device)
        if self.prog.param_shapes() != self.shapes:
            raise ValueError(
                f"{cell.name}: the program's leaves differ from the "
                f"reference's: {self.prog.param_shapes()} vs {self.shapes}")
        if not math.isclose(self.prog.self_weight, t["self_weight"]):
            raise ValueError(f"{cell.name}: the program's graph weighs a "
                             f"worker itself {self.prog.self_weight}, the "
                             f"traffic {t['self_weight']}")
        self.p = t["p"]
        self.check_steps = t["check_rounds"] * self.p
        self.tokens_per_step = t["workers"] * t["batch"] * t["seq"]
        self.elems = yardstick.param_count(self.shapes)
        self.used_rows = yardstick.layout_rows(self.shapes)[1]

    def x0(self) -> dict:
        return weights.make(self.shapes, self.model_ref.init_rule, self.seed,
                            self.device)

    def stream(self, steps: int) -> streams.TokenStream:
        return streams.TokenStream(self.cell.traffic,
                                   self.cell.model["vocab"], self.seed,
                                   steps, self.device)


def program_readings(setup: Setup, stream, mark=None) -> tuple:
    """The program's readings of the first rounds (see
    :mod:`bench.judge`), and its params after them; ``mark(name)`` is
    called after x0 and after the first step."""
    mark = mark or (lambda name: None)
    t = setup.cell.traffic
    x0 = setup.x0()
    xs = weights.stack(x0, t["workers"])
    _sync(setup.device)
    mark("x0")
    _, s1, _ = setup.prog.train(xs, stream.feed(0), 1, log_every=1)
    wd = t["weight_decay"]
    grad1 = leaf_norms({n: s1["m"][n] - wd * xs[n] for n in xs})
    del s1
    _sync(setup.device)
    mark("the first step")
    x, state, hist = setup.prog.train(xs, stream.feed(0), setup.check_steps,
                                      log_every=1)
    readings = {"loss": list(hist.loss), "grad1": grad1,
                "change": change_norms(x, x0),
                "momentum": leaf_norms(state["m"])}
    if "xhat" in state:
        readings["xhat"] = change_norms(state["xhat"], x0)
    return readings, x


def half_batch_mask(batch: dict) -> torch.Tensor:
    """Keeps the first half of each worker's batch (of its positions
    where the batch is one sequence)."""
    labels = batch["labels"]
    mask = torch.zeros(labels.shape, dtype=torch.bool, device=labels.device)
    if labels.shape[1] >= 2:
        mask[:, :labels.shape[1] // 2] = True
    else:
        mask[..., :labels.shape[-1] // 2] = True
    return mask


def reference_readings(setup: Setup, stream, precision: str = "f32",
                       fault=None) -> dict:
    """The reference's readings of the same first rounds: in f32, or in
    the control's precision, or with a fault planted (``half_batch``,
    ``no_exchange``)."""
    x0 = setup.x0()
    batches = [stream.batch(i) for i in range(setup.check_steps)]
    kw = {}
    if fault == "half_batch":
        kw["mask"] = half_batch_mask(batches[0])
    elif fault == "no_exchange":
        kw["drop_exchange"] = True
    elif fault is not None:
        raise ValueError(f"fault {fault!r}")
    ops = Ops(precision)
    rnd = setup.round_ref.Round(setup.cell.traffic, setup.cell.model,
                                setup.model_ref, ops)
    with ops.active():
        return rnd.run(x0, batches, **kw)


@dataclasses.dataclass
class Traced:
    """What a per-layer reader reads, of the traced window:

    * ``dev``: its device events ``(name, cat, start_us, end_us,
      in_exchange)`` (see :func:`bench.tracing.device_events`);
    * ``events``: the whole trace's chrome-trace events, host and device,
      whose ``user_annotation`` events hold the program's spans (read
      through :mod:`bench.spans`) and the harness's window and exchange;
    * ``counters``: each of the program's counters
      (:meth:`bench.program.Program.counters`) by name, its change over the
      window's ``train`` call;
    * its length and busy time, and the work it held: rounds, tokens,
      the traffic's sequence and workers, the parameters and the layout's
      used rows a worker, the configuration's ``model``, the card's peaks
      (``peaks.json``) and the device milliseconds of each
      :func:`bench.tracing.kind`."""
    dev: list
    window_s: float
    busy_s: float
    rounds: int
    tokens: int
    seq: int
    workers: int
    elems: int
    blocks: int
    model: dict
    peaks: dict
    ms_by_kind: dict
    events: list = dataclasses.field(default_factory=list)
    counters: dict = dataclasses.field(default_factory=dict)


def _peaks() -> dict:
    with open(ROOT / "bench" / "peaks.json") as f:
        return json.load(f)


def traced_window(setup: Setup, x, feed, rounds: int) -> tuple:
    """One ``train`` call of ``rounds`` rounds under the profiler, the
    optimizer's exchange inside spans of its own, the program's counters
    read on either side of it: ``(Traced, breakdown, history)``."""
    from torch.profiler import ProfilerActivity, profile, record_function
    acts = [ProfilerActivity.CPU]
    if torch.device(setup.device).type == "cuda":
        acts.append(ProfilerActivity.CUDA)
    before = setup.prog.counters()
    with setup.prog.exchange_spans(tracing.EXCHANGE), \
            profile(activities=acts) as prof:
        with record_function(tracing.WINDOW):
            _, _, hist = setup.prog.train(x, feed, rounds * setup.p)
            _sync(setup.device)
    after = setup.prog.counters()
    counters = {k: v - before.get(k, 0) for k, v in after.items()}
    fd, path = tempfile.mkstemp(suffix=".json")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        events = tracing.load(path)
    finally:
        os.unlink(path)
    lo, hi = tracing.window(events)
    dev = tracing.device_events(events, lo, hi)
    t = setup.cell.traffic
    traced = Traced(
        dev=dev, window_s=(hi - lo) * 1e-6,
        busy_s=tracing.busy_us(dev, lo, hi) * 1e-6, rounds=rounds,
        tokens=rounds * setup.p * setup.tokens_per_step, seq=t["seq"],
        workers=t["workers"], elems=setup.elems, blocks=setup.used_rows,
        model=setup.cell.model, peaks=_peaks(),
        ms_by_kind=tracing.ms_by_kind(dev), events=events,
        counters=counters)
    return traced, tracing.breakdown(events, dev, lo, hi), hist


def card(device) -> dict:
    """The device the run used, as the result line names it."""
    if torch.device(device).type != "cuda":
        return {"platform": "cpu", "kind": "cpu", "count": 1,
                "memory_peak_bytes": 0}
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": 1,
            "memory_peak_bytes": int(torch.cuda.max_memory_allocated())}


def power_limit() -> str:
    """The card's name and power limit, as ``nvidia-smi`` reads them."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader", "-i", "0"], capture_output=True,
            text=True, timeout=20)
    except (OSError, subprocess.TimeoutExpired) as e:
        return f"nvidia-smi unavailable ({e})"
    return out.stdout.strip() or out.stderr.strip()


def run(cell, seed: int, seconds: float, trace: bool, device,
        t_start: float, log=print) -> dict:
    """One run of ``cell``; returns the result line's object."""
    f32_only()
    marks = [("start", t_start)]

    def mark(name):
        marks.append((name, time.perf_counter()))
    mark("imports")
    setup = Setup(cell, seed, device)
    prog, p = setup.prog, setup.p
    stream = setup.stream(setup.check_steps + WARM_ROUNDS * p)
    _sync(device)
    mark("program and stream")
    readings, x = program_readings(setup, stream, mark)
    _sync(device)
    mark("the checked rounds")
    # warm-up: a call of a whole block of rounds (the trainer's default
    # flush), so that the window maps no more device memory; its time
    # sets how many rounds fill the window
    offset = setup.check_steps
    t0 = time.perf_counter()
    x, _, _ = prog.train(x, stream.feed(offset), WARM_ROUNDS * p)
    _sync(device)
    round_s = (time.perf_counter() - t0) / WARM_ROUNDS
    offset += WARM_ROUNDS * p
    rounds = TRACE_ROUNDS if trace else max(1, round(seconds / round_s))
    stream = setup.stream(offset + rounds * p)
    feed = stream.feed(offset)
    # no empty_cache: the window keeps the allocator's warm blocks
    gc.collect()
    mark("warm rounds and staging")
    log("set-up: " + ", ".join(f"{b[0]} {b[1] - a[1]:.3f} s"
                               for a, b in zip(marks, marks[1:])))
    if torch.device(device).type == "cuda":
        torch.cuda.reset_peak_memory_stats()
    result = {"correct": False, "attempted": rounds, "failed": 0,
              "metrics": {}}
    t_window = time.perf_counter()
    setup_s = t_window - t_start
    if trace:
        traced, brk, hist = traced_window(setup, x, feed, rounds)
        for entry in cell.per_layer:
            v = reader(cell, entry["name"])(traced)
            if v is not None:
                result["metrics"][entry["name"]] = {"value": v,
                                                    "unit": entry["unit"]}
    else:
        _, _, hist = prog.train(x, feed, rounds * p)
        _sync(device)
        window_s = time.perf_counter() - t_window
        values = {"tokens_per_s":
                  rounds * p * setup.tokens_per_step / window_s,
                  "setup_s": setup_s}
        if torch.device(device).type == "cuda":
            values["peak_mem_gib"] = torch.cuda.max_memory_allocated() / 2**30
        for entry in cell.end_to_end:
            if entry["name"] in values:
                result["metrics"][entry["name"]] = {
                    "value": values[entry["name"]], "unit": entry["unit"]}
        log(f"window: {rounds} rounds of {p} steps in {window_s:.4f} s "
            f"(warm round {round_s:.4f} s), set-up {setup_s:.3f} s")
    result["device"] = card(device)
    if trace:
        result["device"].update(busy_s=traced.busy_s,
                                window_s=traced.window_s)
        result["breakdown"] = brk
    result["failed"] = sum(1 for v in hist.loss if not math.isfinite(v))
    del x
    free(device)
    t_ref = time.perf_counter()
    ref = reference_readings(setup, stream)
    log(f"reference: {time.perf_counter() - t_ref:.3f} s")
    nums = judge.numbers(readings, ref)
    ok, checks = judge.judge(nums, cell.limits)
    result["correct"] = bool(ok and result["failed"] == 0)
    result["checks"] = checks
    return result
