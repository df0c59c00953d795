"""The reduction of a profiler trace to device time by kind.

A trace is a list of chrome-trace events (``torch.profiler``'s
``export_chrome_trace``): device work has ``cat`` ``kernel``,
``gpu_memcpy`` or ``gpu_memset``; host work ``cpu_op``, ``cuda_runtime``,
``user_annotation`` and the like.  Times are microseconds.

* the traced window is the host span the harness records around it
  (:data:`WINDOW`);
* busy time is the union of the device intervals inside the window (a
  timeline union, not a sum: work on two streams at once counts once),
  and idle time the rest of the window;
* each idle gap is named by what the host was doing when it began: the
  innermost host event open at that instant;
* a device event belongs to the exchange if the host call that launched
  it (the runtime or driver call of the same ``correlation`` id) lies
  inside a span :data:`EXCHANGE`, which the harness puts around the
  optimizer's exchange;
* each device event has a kind (:func:`kind`), from its name, and for a
  matrix product from whether the exchange launched it.
"""
from __future__ import annotations

import bisect
import json
from collections import defaultdict

WINDOW = "bench.window"
EXCHANGE = "bench.exchange"
DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
LAUNCH_CATS = ("cuda_runtime", "cuda_driver")
HOST_CATS = ("cpu_op", "cuda_runtime", "cuda_driver", "user_annotation",
             "python_function")

# names of the program's hand-written kernels (``csrc/*.cu``), by kind
PROGRAM_KERNELS = (("momentum", ("momentum_kernel",
                                 "momentum_inplace_kernel")),
                   ("gossip", ("gossip_mix",)),
                   ("sign_codec", ("sign_pack_kernel", "sign_unpack_kernel")))
GEMM_MARKS = ("gemm", "gemv", "splitk", "cutlass", "xmma")
COPY_MARKS = ("copy", "fill", "memcpy", "memset")


def load(path) -> list:
    """The events of a chrome trace file."""
    with open(path) as f:
        data = json.load(f)
    return data["traceEvents"] if isinstance(data, dict) else data


def kind(name: str, cat: str = "kernel", exchange: bool = False) -> str:
    """``momentum``, ``gossip``, ``sign_codec`` (the program's kernels),
    ``gemm`` (cuBLAS and CUTLASS products outside the exchange: the
    gradient's), ``exchange_gemm`` (those the exchange launched, such as
    CPD's ``W @ x̂``), ``copy_fill`` (copies, fills, memcpy and memset) or
    ``other``."""
    for k, marks in PROGRAM_KERNELS:
        if any(m in name for m in marks):
            return k
    low = name.lower()
    if cat in ("gpu_memcpy", "gpu_memset") or any(m in low
                                                  for m in COPY_MARKS):
        return "copy_fill"
    if any(m in low for m in GEMM_MARKS):
        return "exchange_gemm" if exchange else "gemm"
    return "other"


def spans(events: list, name: str) -> list:
    """``(start, end)`` of each host span ``name`` (a ``record_function``:
    its host side, not its mark on the device's timeline), in time
    order."""
    return sorted((e["ts"], e["ts"] + e["dur"]) for e in events
                  if e.get("name") == name and "dur" in e
                  and e.get("ph") == "X"
                  and e.get("cat") == "user_annotation")


def window(events: list, name: str = WINDOW) -> tuple:
    """``(start, end)`` of the one host span ``name``."""
    found = spans(events, name)
    if len(found) != 1:
        raise ValueError(f"{len(found)} spans named {name!r} in the trace")
    return found[0]


def _inside(t: float, starts: list, ranges: list) -> bool:
    """Whether ``t`` lies in one of the disjoint sorted ``ranges``."""
    i = bisect.bisect_right(starts, t) - 1
    return i >= 0 and t < ranges[i][1]


def device_events(events: list, lo: float, hi: float) -> list:
    """Device events ``(name, cat, start, end, in_exchange)`` that begin
    inside ``[lo, hi)``, in time order; ``in_exchange`` tells whether the
    host call that launched the event lies inside an :data:`EXCHANGE`
    span."""
    launched = {e["args"]["correlation"]: e["ts"] for e in events
                if e.get("cat") in LAUNCH_CATS
                and "correlation" in e.get("args", {})}
    ex = union(spans(events, EXCHANGE), float("-inf"), float("inf"))
    starts = [s for s, _ in ex]
    out = []
    for e in events:
        if e.get("ph") != "X" or e.get("cat") not in DEVICE_CATS \
                or not lo <= e["ts"] < hi:
            continue
        at = launched.get(e.get("args", {}).get("correlation"))
        out.append((e["name"], e["cat"], e["ts"], e["ts"] + e["dur"],
                    at is not None and _inside(at, starts, ex)))
    return sorted(out, key=lambda d: d[2])


def union(intervals, lo: float, hi: float) -> list:
    """The union of ``(start, end)`` intervals, clipped to ``[lo, hi]``,
    as disjoint sorted intervals."""
    merged = []
    for s, e in sorted((max(s, lo), min(e, hi)) for s, e in intervals):
        if e <= s:
            continue
        if merged and s <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], e)
        else:
            merged.append([s, e])
    return [tuple(m) for m in merged]


def busy_us(dev: list, lo: float, hi: float) -> float:
    return sum(e - s for s, e in union(((d[2], d[3]) for d in dev), lo, hi))


def gaps(dev: list, lo: float, hi: float) -> list:
    """The idle ``(start, end)`` stretches of ``[lo, hi]``."""
    out, at = [], lo
    for s, e in union(((d[2], d[3]) for d in dev), lo, hi):
        if s > at:
            out.append((at, s))
        at = max(at, e)
    if hi > at:
        out.append((at, hi))
    return out


class HostIndex:
    """The host events of a trace, sorted by start, to name what the host
    was doing at an instant: the innermost host event open then (the
    latest to begin), found by a search and a short walk back."""

    WALK = 4096

    def __init__(self, events: list):
        host = sorted((e for e in events if e.get("ph") == "X"
                       and e.get("cat") in HOST_CATS),
                      key=lambda e: e["ts"])
        self.starts = [e["ts"] for e in host]
        self.host = host

    def at(self, t: float) -> str:
        i = bisect.bisect_right(self.starts, t) - 1
        for j in range(i, max(i - self.WALK, -1), -1):
            e = self.host[j]
            if t < e["ts"] + e.get("dur", 0):
                return e["name"]
        return "no host event"


def short(name: str, width: int = 96) -> str:
    """A kernel's name without ``void `` and cut to ``width``."""
    if name.startswith("void "):
        name = name[5:]
    return name if len(name) <= width else name[:width - 3] + "..."


def breakdown(events: list, dev: list, lo: float, hi: float,
              top: int = 10) -> dict:
    """The device operations that took most time, and the longest idle
    time by what the host was doing, in seconds."""
    by_op = defaultdict(float)
    for name, _cat, s, e, _ex in dev:
        by_op[short(name)] += (e - s) * 1e-6
    by_host = defaultdict(float)
    index = HostIndex(events)
    for s, e in gaps(dev, lo, hi):
        by_host[short(index.at(s))] += (e - s) * 1e-6
    ops = sorted(by_op.items(), key=lambda kv: -kv[1])[:top]
    idle = sorted(by_host.items(), key=lambda kv: -kv[1])[:top]
    return {"device_ops": [[k, v] for k, v in ops],
            "idle_gaps": [[k, v] for k, v in idle]}


def ms_by_kind(dev: list) -> dict:
    """Device milliseconds of each :func:`kind` (a sum of durations)."""
    out = defaultdict(float)
    for name, cat, s, e, ex in dev:
        out[kind(name, cat, ex)] += (e - s) * 1e-3
    return dict(out)
