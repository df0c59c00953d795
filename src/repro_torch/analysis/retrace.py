"""One op program across a topology schedule.

Port of ``src/repro/analysis/retrace.py``.  The reference promises that
every round of a time-varying graph runs from one compiled executable and
counts XLA compilations over a schedule sweep.  The port compiles nothing
at run time (no ``torch.compile`` anywhere in ``src/repro_torch/``; the
CUDA kernels are built once, by ``kernels/build.py``), so the promise
becomes one **op program**: every round of the sweep, and a round resumed
mid-cycle, dispatches the same aten ops on the same shapes and dtypes,
choosing round r's matrix on the device.  That is the property a CUDA
graph of the round needs (ROADMAP D.4).  :class:`OpTraceCounter` records
each round's program; :func:`check_schedule_no_retrace` also counts the
``nvcc`` builds after the first round, which must be none.
"""
from __future__ import annotations

import contextlib
from typing import List

import torch

from repro_torch.analysis.round_check import (OpLog, toy_batches,
                                              toy_grads_fn, toy_params)

__all__ = ["OpTraceCounter", "check_schedule_no_retrace"]


class OpTraceCounter:
    """Each round's op program (:meth:`OpLog.program`), and the ``nvcc``
    builds of ``kernels/build.py`` since the last :meth:`reset_builds`.

    >>> cc = OpTraceCounter()
    >>> with cc.round():
    ...     run_one_round()
    >>> cc.count()      # distinct programs"""

    def __init__(self):
        self.programs: List[tuple] = []
        self.builds = 0

    @contextlib.contextmanager
    def round(self):
        from repro_torch.kernels import build
        inner = build.build

        def counted(*a, **k):
            logs = inner(*a, **k)
            self.builds += len(logs)
            return logs
        build.build = counted
        try:
            with OpLog() as log:
                yield log
        finally:
            build.build = inner
        self.programs.append(log.program())

    def reset_builds(self):
        self.builds = 0

    def count(self) -> int:
        return len(set(self.programs))


def check_schedule_no_retrace(make_round=None, *, n_workers: int = 8,
                              schedule: str = "one_peer_exp", p: int = 2,
                              device="cpu") -> List[str]:
    """A full schedule cycle and a mid-cycle resume (``state["step"]`` set
    to ``(period // 2 + 1)·p``, as a checkpoint restore does) under the
    counter.  ``make_round()`` may supply ``(round_fn, params, state,
    batches, period)``; the default is PD-SGDM's tree round on
    ``DenseComm`` with the named schedule.  Returns violation strings
    (empty: one program, and no build after the first round)."""
    if make_round is None:
        def make_round():
            return _default_round(n_workers, schedule, p, device)
    round_fn, params, state, batches, period = make_round()
    cc = OpTraceCounter()
    for i in range(period + 1):
        with cc.round():
            params, state, _losses = round_fn(params, state, batches)
        if i == 0:
            cc.reset_builds()
    state2 = dict(state)
    state2["step"] = torch.full((), (period // 2 + 1) * p, dtype=torch.int32,
                                device=state["step"].device)
    with cc.round():
        round_fn(params, state2, batches)
    out = []
    n = cc.count()
    if n != 1:
        lens = [len(pr) for pr in cc.programs]
        out.append(f"schedule sweep + mid-cycle resume ran {n} distinct op "
                   f"programs (expected exactly 1); ops per round {lens}")
    if cc.builds:
        out.append(f"kernels/build.py ran nvcc for {cc.builds} source(s) "
                   "after the first round")
    return out


def _default_round(n_workers: int, schedule: str, p: int, device):
    from repro_torch.core import PDSGDM, PDSGDMConfig
    from repro_torch.core.gossip import DenseComm
    from repro_torch.core.topology import make_schedule

    sched = make_schedule(schedule, (n_workers,))
    opt = PDSGDM(PDSGDMConfig(eta=0.05, mu=0.9, p=p),
                 DenseComm(sched, device=device))
    params = toy_params(n_workers, device=device)
    state = opt.init(params)
    batches = toy_batches(p, n_workers, device)

    def round_fn(params, state, batches):
        return opt.round(state, params, toy_grads_fn, batches)

    return round_fn, params, state, batches, sched.period
