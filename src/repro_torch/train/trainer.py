"""Round-based training loops: the dense K-worker simulation
(``SimTrainer``) and the sharded runtime's (``ShardedTrainer``).

Port of ``src/repro/train/trainer.py``: ``History`` and ``SimTrainer``,
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

``ShardedTrainer`` drives a ``TrainPack`` (:mod:`repro_torch.launch.runtime`)
in every rank: whole rounds through ``pack.train_round``, a tail or an
off-boundary resume through ``pack.train_step``.  Losses stay on the
device until a log block flushes; the flush is the one collective of the
log path (the workers' mean loss per step, so every rank logs the same
global loss).  Comm MB come from ``bytes_per_round_cycle``, the
reference's per-worker figure.  With ``ckpt_every`` rank 0 gathers the K
workers' slices, where a worker spans several ranks each reassembled
from its ranks' shards (split over TP, FSDP or both), and writes the
K-stacked whole trees (the same files as a dense run's, whatever the
split); ``resume=True`` restores through
``restore_elastic`` (K→K′ too) and continues bit for bit from a round
boundary, or on the per-step path until the next one.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Callable, Dict, List, Optional

import torch
import torch.distributed as dist

from repro_torch import resolve_device
from repro_torch.core.pdsgdm import PDSGDM
from repro_torch.spans import MODEL_FORWARD, TRAINER_FLUSH, span
from repro_torch.tree import tree_leaves, tree_map

__all__ = ["SimTrainer", "History", "ShardedTrainer", "gather_workers"]

# cap on the derived block size (rounds between two host syncs)
_MAX_BLOCK_ROUNDS = 16
# the tag of the checkpoint gather's point-to-point messages
_GATHER_TAG = 1 << 21


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

        def value(p, b):
            with span(MODEL_FORWARD):
                return loss_fn(p, b)[0]
        self._grad = torch.func.vmap(torch.func.grad_and_value(value))

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
            with span(TRAINER_FLUSH):
                logged = len(hist.steps)
                # .tolist() is the block's one host sync
                _log_chunk(hist, torch.cat(losses).tolist(), t0, steps=steps,
                           log_every=log_every, p=p,
                           per_round_bytes=per_round)
                new = len(hist.steps) - logged
                if eval_fn is not None and new:
                    avg = tree_map(lambda x: x.mean(0, keepdim=True)
                                   .expand_as(x).contiguous(), params)
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


def gather_workers(tree, keys, layout, plan=None):
    """The K-stacked tree on rank 0 (None elsewhere): each worker-stacked
    leaf (``keys``: the ``check_state_keys`` marks, True for every params
    leaf) sent to rank 0 by point to point from every rank that holds a
    part rank 0 needs (gloo's ``gather`` moves a sixth of the bytes a
    second), through the host under gloo; where a worker spans several
    ranks each worker's leaf is reassembled from its ranks' shards (the
    layout's, row-major over the inner axes: (FSDP, TP) under profile B)
    by the shard ``plan`` (the leaf's name is its innermost key; without
    a plan the ranks hold replicas and only the first sends); the other
    leaves as rank 0 holds them.  Collective."""
    mesh = layout.mesh
    root = mesh.rank == 0
    on_host = mesh.backend == "gloo"
    owners = [[layout.rank_of(w, i) for i in range(layout.worker_ranks)]
              for w in range(layout.n_workers)]
    if plan is None:
        owners = [ranks[:1] for ranks in owners]
    senders = sorted({r for ranks in owners for r in ranks} - {0})

    def gather(leaf, name):
        t = leaf.detach().contiguous()
        if on_host:
            t = t.cpu()
        if root:
            bufs = {r: torch.empty_like(t) for r in senders}
            bufs[0] = t
            reqs = [dist.irecv(bufs[r], r, tag=_GATHER_TAG)
                    for r in senders]
        else:
            reqs = ([dist.isend(t, 0, tag=_GATHER_TAG)]
                    if mesh.rank in senders else [])
        for q in reqs:
            q.wait()
        if not root:
            return None
        parts = [plan.unshard(name, [bufs[r] for r in ranks])
                 if len(ranks) > 1 else bufs[ranks[0]] for ranks in owners]
        return torch.cat(parts).cpu()

    def walk(sub, mark, name=None):
        if isinstance(sub, dict):
            return {k: walk(v, mark[k] if isinstance(mark, dict) else mark,
                            k) for k, v in sub.items()}
        if mark:
            return gather(sub, name)
        return sub.detach().cpu() if root else None

    return walk(tree, keys)


class ShardedTrainer:
    """The sharded training loop over a ``TrainPack``, in every rank.

    * the hot path is ``pack.train_round`` (p local steps + one gossip);
    * losses stay on the device until a log block flushes, and the flush
      averages them over the workers (one ``all_reduce``): every rank logs
      the same global loss;
    * comm MB come from the optimizer's ``bytes_per_round_cycle``;
    * checkpoints hold params and the whole optimizer state, K-stacked
      (rank 0 gathers); ``resume=True`` continues bit for bit from a round
      boundary, and from an off-boundary checkpoint on the per-step path
      until the next boundary."""

    def __init__(self, pack, ckpt_dir: Optional[str] = None,
                 ckpt_every: int = 0):
        self.pack = pack
        self.ckpt_dir = ckpt_dir
        self.ckpt_every = ckpt_every

    def bytes_per_round(self) -> int:
        """The reference's per-worker bytes of round 0: the byte model on
        the whole worker's tree, one plan."""
        return self.bytes_per_round_cycle()[0]

    def bytes_per_round_cycle(self) -> tuple:
        """The reference's per-worker bytes over one schedule cycle (the
        comm-MB of the log)."""
        from repro_torch.launch.runtime import per_worker
        return self.pack.opt.bytes_per_round_cycle(
            per_worker(self.pack.worker_struct))

    def rank_bytes_per_round_cycle(self) -> tuple:
        """What this rank hands to ``isend`` a round, over one cycle: the
        byte model on its own shards and plan.  With one rank a worker it
        is :meth:`bytes_per_round_cycle`; where a worker spans several
        ranks a worker's figure is the sum over its ranks, which exceeds
        the reference's one-plan figure by every leaf a rank holds whole
        (each rank ships its copy, as each device of the reference's
        ``shard_map`` does: under ``inner="dp"`` the whole plan from every
        rank) and, on the kernel layout, by the tail rows of each shard's
        last 1,024-lane row."""
        from repro_torch.launch.runtime import per_worker
        return self.pack.opt.bytes_per_round_cycle(
            per_worker(self.pack.params_struct))

    def _stacked(self, struct, k: int):
        """``struct`` (this rank's worker, leading dim 1) as a K-stacked
        template."""
        def f(s):
            shape = tuple(s.shape)
            if len(shape) >= 1 and shape[0] == 1:
                shape = (k,) + shape[1:]
            return torch.empty(shape, dtype=s.dtype, device="meta")

        def walk(sub):
            if isinstance(sub, dict):
                return {kk: walk(v) for kk, v in sub.items()}
            return f(sub)
        return walk(struct)

    def _restore(self, step: int):
        """This rank's worker of the checkpoint of ``step``, written by any
        fleet size (``restore_elastic``)."""
        from repro_torch.checkpoint import elastic
        pack = self.pack
        K = pack.layout.n_workers
        w = pack.layout.worker_index
        out = elastic.restore_elastic(
            self.ckpt_dir, step,
            params_template=self._stacked(pack.worker_struct, K),
            state_template=self._stacked(pack.worker_state_struct, K),
            comm=pack.opt.comm, device=pack.device)
        plan = pack.plan

        def mine(sub, mark, name=None):
            if isinstance(sub, dict):
                return {k: mine(v, mark[k] if isinstance(mark, dict)
                                else mark, k) for k, v in sub.items()}
            if not mark:
                return sub
            sub = sub[w:w + 1]
            if plan is not None:
                sub = plan.shard(name, sub)
            return sub.clone(memory_format=torch.contiguous_format)
        return (mine(out["params"], True),
                mine(out["opt_state"], pack.state_keys))

    def save(self, step: int, params, state) -> None:
        """Rank 0 writes the K-stacked params and state of ``step``; every
        rank takes part in the gather and waits for the write."""
        from repro_torch.checkpoint import checkpoint as ckpt
        layout, plan = self.pack.layout, self.pack.plan
        p = gather_workers(params, True, layout, plan)
        s = gather_workers(state, self.pack.state_keys, layout, plan)
        if layout.mesh.rank == 0:
            ckpt.save(self.ckpt_dir, step, params=p, opt_state=s)
        dist.barrier()

    def _global_losses(self, losses) -> list:
        """The workers' mean of each step's loss: one ``all_reduce`` over
        the ranks at this rank's inner place (a worker's ranks share its
        loss)."""
        layout = self.pack.layout
        mesh = layout.mesh
        t = losses.detach().to(torch.float32)
        if mesh.backend == "gloo":
            t = t.cpu()
        if layout.worker_axes:
            dist.all_reduce(t, group=layout.worker_group)
        return (t / layout.n_workers).tolist()

    def train(self, seed: int, batch_fn: Callable[[int], dict], steps: int,
              log_every: int = 10, verbose: bool = True,
              resume: bool = False) -> Dict:
        """``steps`` steps from the init of ``seed`` (or the latest
        checkpoint with ``resume``); ``batch_fn(t)`` gives step t's batch
        of this rank's worker (leading dim 1).  Returns ``{"params",
        "state", "history", "steps_run"}``."""
        from repro_torch.checkpoint import checkpoint as ckpt
        pack = self.pack
        p = pack.opt.config.p
        params = state = None
        start = 0
        if resume and not self.ckpt_dir:
            raise ValueError(
                "resume=True needs a checkpoint directory (ckpt_dir)")
        if resume:
            last = ckpt.latest_step(self.ckpt_dir)
            if last is not None:
                params, state = self._restore(last)
                start = last
        if params is None:
            params, state = pack.init_fn(seed)
        if start >= steps and verbose:
            print(f"resume: checkpoint step {start} >= steps {steps}, "
                  "nothing to run")
        hist = History()
        per_round = self.bytes_per_round_cycle()
        wall0 = time.time()
        pending: list = []             # [(first step, device losses)]

        def flush():
            if not pending:
                return
            logged = len(hist.steps)
            t0 = pending[0][0]
            losses = self._global_losses(torch.cat([l for _, l in pending]))
            _log_chunk(hist, losses, t0, steps=steps, log_every=log_every,
                       p=p, per_round_bytes=per_round)
            if verbose:
                for i in range(logged, len(hist.steps)):
                    print(f"step {hist.steps[i]:5d} loss {hist.loss[i]:.4f} "
                          f"comm {hist.comm_mb[i]:.1f} MB "
                          f"({time.time() - wall0:.1f}s)")
            pending.clear()

        t = start
        while t < steps:
            if t % p == 0 and steps - t >= p:
                batches = _stack_batches([batch_fn(t + i) for i in range(p)])
                params, state, losses = pack.train_round(params, state,
                                                         batches, t)
                n = p
            else:
                # off a round boundary (a resume from a tail checkpoint) or
                # a tail shorter than a round: the per-step path, whose
                # gossip keys on the restored step counter
                params, state, loss = pack.train_step(params, state,
                                                      batch_fn(t), t)
                losses, n = loss.reshape(1), 1
            pending.append((t, losses))
            t += n
            if t >= steps or any(_should_log(tt, steps, log_every)
                                 for tt in range(t - n, t)):
                flush()
            if (self.ckpt_dir and self.ckpt_every
                    and t // self.ckpt_every > (t - n) // self.ckpt_every):
                self.save(t, params, state)
        flush()
        return {"params": params, "state": state, "history": hist,
                "steps_run": t - start}
