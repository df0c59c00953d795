"""Fault injection for elastic membership: scripts, a driver, a byte oracle.

Port of ``src/repro/testing/chaos.py``.

* **Scripts**: :func:`chaos_script` draws a seeded kill / revive /
  straggle sequence (numpy's ``default_rng``, so a seed gives the
  reference's script) that never leaves fewer than ``min_live`` live
  workers; :func:`membership_for` compiles it into a
  :class:`~repro_torch.core.topology.MembershipSchedule`.
* **Driver**: :func:`run_dense_chaos` runs any fused-round optimizer on a
  ``DenseComm`` that carries the membership for ``n_rounds`` rounds,
  warm-starts each reviving worker from a live donor before its revival
  round, and records per round the consensus distance and the loss of the
  averaged model over live workers, the live count and the accounted
  fleet bytes.
* **Oracle**: :func:`oracle_fleet_bytes` counts the bytes a round ships
  from the support of the structure matrix and the round's active mask
  (and, for CPD-SGDM, a commit set derived here), never from
  ``edges_per_worker`` or ``CPDSGDM._commit_mask``, so that accounted ≡
  shipped is checked along another path.  It takes every off-diagonal
  entry for a distinct edge: true of the ring, exponential and complete
  graphs at K ≥ 3.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Dict, List, Optional, Sequence

import numpy as np
import torch

from repro_torch.checkpoint.elastic import pick_donor, warm_start_worker
from repro_torch.core.topology import (MembershipSchedule,
                                       membership_from_events)
from repro_torch.tree import tree_leaves, tree_map

__all__ = ["ChaosEvent", "ChaosRun", "chaos_script", "check_round_matrix",
           "membership_for", "oracle_fleet_bytes", "revivals_by_round",
           "run_dense_chaos"]


@dataclasses.dataclass(frozen=True)
class ChaosEvent:
    """One membership fault: ``kind`` ∈ {kill, revive, straggle}, at
    communication round ``round``, of worker ``worker``.  A kill holds
    until the matching revive; a straggle masks one round."""
    round: int
    kind: str
    worker: int


def chaos_script(n_workers: int, n_rounds: int, *, seed: int,
                 kill_prob: float = 0.15, straggle_prob: float = 0.15,
                 down_rounds: int = 2, min_live: int = 2
                 ) -> List[ChaosEvent]:
    """Seeded churn: each round each live worker dies with ``kill_prob``
    (and revives ``down_rounds`` rounds later) or straggles one round with
    ``straggle_prob``.  A kill that would leave fewer than ``min_live``
    live workers is skipped.  Deterministic in ``seed``."""
    rng = np.random.default_rng(seed)
    live = np.ones(n_workers, dtype=bool)
    pending: Dict[int, List[int]] = {}          # revive round -> workers
    events: List[ChaosEvent] = []
    for r in range(n_rounds):
        for w in pending.pop(r, []):
            events.append(ChaosEvent(r, "revive", w))
            live[w] = True
        for w in range(n_workers):
            if not live[w]:
                continue
            u = rng.random()
            if u < kill_prob and live.sum() > min_live:
                events.append(ChaosEvent(r, "kill", w))
                live[w] = False
                back = r + down_rounds
                if back < n_rounds:
                    pending.setdefault(back, []).append(w)
            elif u < kill_prob + straggle_prob:
                events.append(ChaosEvent(r, "straggle", w))
    return events


def membership_for(n_workers: int, n_rounds: int,
                   events: Sequence[ChaosEvent]) -> MembershipSchedule:
    """A chaos script compiled into the core membership schedule."""
    return membership_from_events(n_workers, n_rounds, events)


def revivals_by_round(events: Sequence[ChaosEvent]) -> Dict[int, List[int]]:
    """round -> the workers rejoining at that round."""
    out: Dict[int, List[int]] = {}
    for ev in events:
        if ev.kind == "revive":
            out.setdefault(ev.round, []).append(ev.worker)
    return out


# ------------------------------------------------------------------ invariants
def check_round_matrix(comm, r: int, atol: float = 1e-12) -> np.ndarray:
    """Assert that round ``r``'s effective mixing matrix honours the
    liveness mask: rows sum to 1, a masked-out worker's row is e_k, and no
    active row reads a masked-out column.  Returns the matrix."""
    W = np.asarray(comm.effective_matrix(r), dtype=np.float64)
    act = np.asarray(comm.active_at(r), dtype=bool)
    K = W.shape[0]
    np.testing.assert_allclose(W.sum(axis=1), np.ones(K), atol=atol,
                               err_msg=f"round {r}: rows not stochastic")
    for k in np.flatnonzero(~act):
        np.testing.assert_allclose(
            W[k], np.eye(K)[k], atol=atol,
            err_msg=f"round {r}: masked worker {k} row is not e_k")
    dead_cols = W[np.ix_(act, ~act)]
    if dead_cols.size:
        np.testing.assert_allclose(
            dead_cols, 0.0, atol=atol,
            err_msg=f"round {r}: active rows read masked-out columns")
    return W


# ----------------------------------------------------------------- byte oracle
def _support_edges(comm, r: int):
    """Directed (receiver, source) pairs of round ``r``'s structure graph:
    the off-diagonal support of the unmasked mixing matrix."""
    Wt = np.asarray(comm.topology_at(r).W)
    K = Wt.shape[0]
    return [(k, j) for k in range(K) for j in range(K)
            if k != j and Wt[k, j] != 0.0]


def _numel(leaf) -> int:
    return int(np.prod(tuple(leaf.shape), dtype=np.int64))


def _leaf_bytes(params) -> int:
    return sum(_numel(l) * l.dtype.itemsize for l in tree_leaves(params))


def _codec_bytes(codec, params) -> int:
    return sum(codec.wire_bytes(_numel(l)) for l in tree_leaves(params))


def oracle_fleet_bytes(opt, params, r: int) -> float:
    """Fleet-total bytes that round ``r``'s exchange ships, counted from
    the structure graph and the active mask (and, for CPD-SGDM, a commit
    set derived from the matrix support).  Compare with ``n_workers ×
    opt.bytes_per_comm_round(params, r)``, which goes through
    ``edges_per_worker`` and the commit table instead.  ``params`` is one
    worker's tree."""
    from repro_torch.core.cpdsgdm import CPDSGDM
    from repro_torch.core.tracking import MTDSGDm

    comm = opt.comm
    act = np.asarray(comm.active_at(r), dtype=bool)
    edges = _support_edges(comm, r)
    live_edges = sum(1 for (k, j) in edges if act[k] and act[j])

    if isinstance(opt, CPDSGDM):
        # source j ships iff j and every receiver of j (its copy-holders)
        # are active
        K = act.shape[0]
        receivers: Dict[int, List[int]] = {j: [] for j in range(K)}
        for (k, j) in edges:
            receivers[j].append(k)
        commit = [act[j] and all(act[k] for k in receivers[j])
                  for j in range(K)]
        shipped_edges = sum(len(receivers[j])
                            for j in range(K) if commit[j])
        if opt.config.packed_wire and opt.codec is not None:
            per_edge = _codec_bytes(opt.codec, params)
        else:
            per_edge = 4 * sum(_numel(l) for l in tree_leaves(params))
        return float(shipped_edges * per_edge)

    x_edge = _leaf_bytes(params)
    if isinstance(opt, MTDSGDm):
        if opt.codec is not None:
            c_edge = _codec_bytes(opt.codec, params)
        else:
            c_edge = 4 * sum(_numel(l) for l in tree_leaves(params))
        return float(live_edges * (x_edge + c_edge))
    return float(live_edges * x_edge)          # PD / QG: x only


# --------------------------------------------------------------------- driver
@dataclasses.dataclass
class ChaosRun:
    """Per-round survivor metrics of a chaos drive.

    ``consensus[r]``: RMS distance of the live workers' params to their
    mean after round ``r``; ``avg_loss[r]``: the loss of the live-averaged
    model; ``live[r]``: the live count; ``accounted_bytes[r]``: the fleet
    bytes the optimizer charged for the round."""
    params: Any
    state: Any
    consensus: np.ndarray
    avg_loss: np.ndarray
    live: np.ndarray
    accounted_bytes: np.ndarray


def _consensus_rms(params, live_mask) -> float:
    """RMS distance to the live mean, in float64 on the host."""
    idx = np.flatnonzero(live_mask)
    total, count = 0.0, 0
    for leaf in tree_leaves(params):
        sub = leaf.detach().cpu().numpy()[idx].astype(np.float64)
        mean = sub.mean(axis=0, keepdims=True)
        total += float(((sub - mean) ** 2).sum())
        count += sub.size
    return float(np.sqrt(total / max(count, 1)))


def run_dense_chaos(opt, events: Sequence[ChaosEvent], params,
                    grads_fn: Callable, n_rounds: int, *,
                    loss_fn: Optional[Callable] = None,
                    warm_start: bool = True) -> ChaosRun:
    """Drive ``n_rounds`` fused rounds of ``opt``, whose ``DenseComm``
    carries the script's membership, from worker-stacked ``params``.

    At each revival round the rejoining worker's params and optimizer
    state are cloned from the nearest other live worker on the ring order
    (:func:`~repro_torch.checkpoint.elastic.warm_start_worker`) before the
    round runs.  ``grads_fn(params, batch) -> (loss, grads)`` is the fused
    round's callback; each round hands it p dummy batches.  ``loss_fn``
    maps stacked params to the loss of the averaged-model metric (default:
    the loss part of ``grads_fn``)."""
    ms = opt.comm.membership
    if ms is None:
        raise ValueError("run_dense_chaos: opt.comm carries no membership")
    revive_at = revivals_by_round(events)
    device = tree_leaves(params)[0].device
    batches = {"dummy": torch.zeros((opt.config.p, 1), device=device)}
    per_worker = tree_map(lambda x: x[0], params)
    if loss_fn is None:
        loss_fn = lambda pp: grads_fn(pp, None)[0]  # noqa: E731

    state = opt.init(params)
    consensus, avg_loss, live_n, acc_bytes = [], [], [], []
    for r in range(n_rounds):
        if warm_start:
            for w in revive_at.get(r, []):
                live_now = ms.live_at(r).copy()
                live_now[w] = False            # the donor is someone else
                donor = pick_donor(live_now, w)
                params, state = warm_start_worker(params, state,
                                                  joiner=w, donor=donor)
        params, state, _ = opt.round(state, params, grads_fn, batches)
        live = np.asarray(ms.live_at(r), dtype=bool)
        consensus.append(_consensus_rms(params, live))
        idx = torch.as_tensor(np.flatnonzero(live), device=device)
        mean_p = tree_map(
            lambda x: x.index_select(0, idx).mean(0, keepdim=True)
            .expand_as(x), params)
        avg_loss.append(float(loss_fn(mean_p).mean()))
        live_n.append(int(live.sum()))
        acc_bytes.append(
            float(ms.n_workers * opt.bytes_per_comm_round(per_worker, r=r)))
    return ChaosRun(params=params, state=state,
                    consensus=np.asarray(consensus),
                    avg_loss=np.asarray(avg_loss),
                    live=np.asarray(live_n, dtype=np.int64),
                    accounted_bytes=np.asarray(acc_bytes))
