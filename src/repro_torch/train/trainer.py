"""Round-based training loop of the dense K-worker simulation.

Port of ``History`` and ``SimTrainer`` (``src/repro/train/trainer.py:45-216``),
with the eval hook: ``train(..., eval_fn=...)`` hands the worker average,
re-stacked over the K workers, to ``eval_fn`` once per block that holds a
log point, and records its value beside each of those log points.
``SimTrainer`` runs whole rounds (p local momentum steps + exactly one
gossip round, ``opt.round``) in blocks of ``rounds_per_log`` rounds, by
default enough to reach the next log point and at most
``_MAX_BLOCK_ROUNDS``.  Per-step losses stay on the device until a block
is flushed: one host sync per block.  A run whose length is not a multiple of p ends
with a tail of local steps and no gossip, reproducing the per-step
schedule ``mod(t+1, p) == 0`` exactly.  Per-worker ``(loss, grads)`` come
from ``torch.func.vmap(torch.func.grad_and_value(...))`` over the
worker-stacked params.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, List, Optional

import torch

from repro_torch import resolve_device
from repro_torch.core.pdsgdm import PDSGDM
from repro_torch.tree import tree_leaves, tree_map

__all__ = ["SimTrainer", "History"]

# cap on the derived block size (rounds between two host syncs)
_MAX_BLOCK_ROUNDS = 16


@dataclasses.dataclass
class History:
    steps: List[int] = dataclasses.field(default_factory=list)
    loss: List[float] = dataclasses.field(default_factory=list)
    comm_mb: List[float] = dataclasses.field(default_factory=list)
    eval_metric: List[float] = dataclasses.field(default_factory=list)

    def rows(self):
        """One dict per log point: step, loss, comm-MB and the eval value
        (None without an ``eval_fn``)."""
        for i, s in enumerate(self.steps):
            yield {"step": s, "loss": self.loss[i],
                   "comm_mb": self.comm_mb[i],
                   "eval": self.eval_metric[i] if self.eval_metric else None}


def _stack_batches(batches: list) -> dict:
    """Stack a list of batch dicts into one with a leading step dim."""
    return {k: torch.stack([b[k] for b in batches]) for k in batches[0]}


def _should_log(t, steps, log_every):
    return t % log_every == 0 or t == steps - 1


def _bytes_through(n_rounds: int, per_round_bytes) -> float:
    """Cumulative bytes after ``n_rounds`` gossip rounds; ``per_round_bytes``
    is the per-round cycle from ``opt.bytes_per_round_cycle``."""
    T = len(per_round_bytes)
    full, rem = divmod(n_rounds, T)
    return full * sum(per_round_bytes) + sum(per_round_bytes[:rem])


def _log_chunk(hist, losses, t0, *, steps, log_every, p, per_round_bytes):
    """Append History entries for the log points inside one executed chunk.

    ``losses`` holds the per-step losses (host floats) from global step
    ``t0``; ``(t+1) // p`` gossip rounds have completed through step t.
    """
    for i, lv in enumerate(losses):
        t = t0 + i
        if not _should_log(t, steps, log_every):
            continue
        hist.steps.append(t)
        hist.loss.append(float(lv))
        hist.comm_mb.append(
            _bytes_through((t + 1) // p, per_round_bytes) / 2 ** 20)


class SimTrainer:
    """Decentralized training simulation over K stacked workers on
    ``device``; the host waits for the device only when a block of rounds
    is flushed."""

    def __init__(self, loss_fn: Callable, opt: PDSGDM, device="cuda",
                 rounds_per_log: Optional[int] = None):
        self.loss_fn = loss_fn
        self.opt = opt
        self.device = resolve_device(device)
        self.rounds_per_log = rounds_per_log
        self._grad = torch.func.vmap(torch.func.grad_and_value(
            lambda p, b: loss_fn(p, b)[0]))

    def _grads_fn(self, params, batch):
        grads, losses = self._grad(params, batch)
        return losses.mean(), grads

    def bytes_per_round_cycle(self, params) -> tuple:
        return self.opt.bytes_per_round_cycle(tree_map(lambda x: x[0], params))

    def train(self, params, batch_fn: Callable[[int], dict], steps: int,
              log_every: int = 10, eval_fn: Optional[Callable] = None,
              rounds_per_log: Optional[int] = None) -> tuple:
        """Run ``steps`` local steps from worker-stacked ``params``;
        ``batch_fn(t)`` gives step t's worker-stacked batch.
        ``rounds_per_log`` (here or at construction) sets the rounds
        between two host syncs.  ``eval_fn(avg_params) -> float`` gets the
        worker average re-stacked to K workers at the end of each round (or
        tail) that holds a log point: one value per log point, in
        ``History.eval_metric``.  Returns ``(params, state, History)``."""
        for leaf in tree_leaves(params):
            if leaf.device.type != self.device.type:
                raise ValueError(f"params on {leaf.device}, trainer on "
                                 f"{self.device}")
        opt = self.opt
        state = opt.init(params)
        hist = History()
        per_round = self.bytes_per_round_cycle(params)
        p = opt.config.p
        n_rounds, tail = divmod(steps, p)
        explicit = rounds_per_log or self.rounds_per_log
        if eval_fn is not None:
            # params exist only at block boundaries: a larger block would
            # pair a log step with an eval taken a whole block later
            if explicit not in (None, 1):
                raise ValueError(
                    "eval_fn needs rounds_per_log=1: params only exist at "
                    "block boundaries, so a larger block would mis-pair "
                    "eval values with log steps")
            block = 1
        else:
            # the caller's, else enough to reach the next log point, capped
            block = explicit or min(_MAX_BLOCK_ROUNDS,
                                    max(1, -(-log_every // p)))

        def flush(losses, t0, params):
            logged = len(hist.steps)
            # .tolist() is the block's one host sync
            _log_chunk(hist, torch.cat(losses).tolist(), t0, steps=steps,
                       log_every=log_every, p=p, per_round_bytes=per_round)
            new = len(hist.steps) - logged
            if eval_fn is not None and new:
                avg = tree_map(lambda x: x.mean(0, keepdim=True).expand_as(x)
                               .contiguous(), params)
                hist.eval_metric.extend([float(eval_fn(avg))] * new)

        done = 0                                   # steps completed
        while done < n_rounds * p:
            r = min(block, n_rounds - done // p)
            losses = []
            for j in range(r):
                t0 = done + j * p
                batches = _stack_batches([batch_fn(t0 + i) for i in range(p)])
                params, state, lv = opt.round(state, params, self._grads_fn,
                                              batches)
                losses.append(lv)
            flush(losses, done, params)
            done += r * p
        if tail:
            batches = _stack_batches([batch_fn(done + i) for i in range(tail)])
            params, state, lv = opt.round(state, params, self._grads_fn,
                                          batches, gossip=False)
            flush([lv], done, params)
        return params, state, hist
