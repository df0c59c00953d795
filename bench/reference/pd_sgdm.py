"""PD-SGDM's first rounds (paper Algorithm 1), worker by worker, in f32.

From x0 on every worker, each round: p local steps, each
``m ← μ·m + (g + wd·x)``, ``x ← x − η·m`` with g the worker's own
gradient of its own batch; then one gossip ``x_k ← Σ_j w_kj x_j`` over the traffic's graph (a ring of K:
1/3 to itself and to each neighbour).  The gradients come from plain
autograd, one worker at a time; the updates and the mix run leaf by leaf,
so the round fits beside nothing but its own K copies of x and m.

:meth:`Round.run` returns the readings the judge compares: each step's
loss (the mean over the workers), each leaf's norm of the first gradient
(over the K workers), and after the rounds each leaf's norm of the
change ``x − x0`` and of the momentum.  ``drop_exchange`` leaves the
gossip out and ``mask`` keeps a subset of each batch's positions: the two
faults a training cell can have that need a run.
"""
from __future__ import annotations

import torch


def ring_matrix(workers: int, self_weight: float, device) -> torch.Tensor:
    """The ring's mixing matrix (three or more workers): ``self_weight``
    on the diagonal, the rest split between the two neighbours."""
    if workers < 3:
        raise ValueError(f"a ring of {workers} has no two distinct "
                         "neighbours")
    w = torch.zeros((workers, workers), dtype=torch.float32, device=device)
    side = (1.0 - self_weight) / 2.0
    for k in range(workers):
        w[k, k] = self_weight
        w[k, (k + 1) % workers] += side
        w[k, (k - 1) % workers] += side
    return w


def leaf_norms(tree: dict) -> dict:
    """Each leaf's 2-norm (in f64), over every worker it holds."""
    return {n: float(torch.linalg.vector_norm(t.to(torch.float64)))
            for n, t in tree.items()}


def change_norms(tree: dict, x0: dict) -> dict:
    """Each leaf's norm of ``tree − x0`` (x0 one worker's, broadcast)."""
    return {n: float(torch.linalg.vector_norm((t - x0[n]).to(torch.float64)))
            for n, t in tree.items()}


class Round:
    def __init__(self, traffic: dict, model: dict, model_ref, ops):
        if traffic["topology"] != "ring":
            raise ValueError(f"no reference for graph {traffic['topology']}")
        self.t, self.model, self.ref, self.ops = traffic, model, model_ref, ops

    def _grads(self, x: dict, k: int, batch: dict, mask):
        leaves = {n: t[k].detach().requires_grad_(True) for n, t in x.items()}
        loss = self.ref.loss(leaves, batch, self.model, self.ops, mask)
        grads = torch.autograd.grad(loss, list(leaves.values()))
        return float(loss.detach()), dict(zip(leaves, grads))

    def local_steps(self, x: dict, m: dict, batches: list, mask=None):
        """p momentum steps, in place on x and m; returns the losses and
        the first step's gradient norms."""
        t = self.t
        losses, grad1 = [], None
        for step, batch in enumerate(batches):
            per_worker, sq = [], {n: 0.0 for n in x}
            for k in range(t["workers"]):
                one = {key: v[k] for key, v in batch.items()}
                wmask = None if mask is None else mask[k]
                lv, g = self._grads(x, k, one, wmask)
                per_worker.append(lv)
                with torch.no_grad():
                    for n, gk in g.items():
                        if step == 0:
                            sq[n] += float(torch.linalg.vector_norm(
                                gk.to(torch.float64))) ** 2
                        gk = gk + t["weight_decay"] * x[n][k]
                        m[n][k].mul_(t["mu"]).add_(gk)
                        x[n][k].sub_(t["eta"] * m[n][k])
                del g
            losses.append(sum(per_worker) / len(per_worker))
            if step == 0:
                grad1 = {n: v ** 0.5 for n, v in sq.items()}
        return losses, grad1

    def mix(self, x: dict):
        """One gossip over the ring, leaf by leaf, in place."""
        W = ring_matrix(self.t["workers"], self.t["self_weight"],
                        next(iter(x.values())).device)
        with torch.no_grad():
            for n, v in x.items():
                flat = v.reshape(v.shape[0], -1)
                flat.copy_(self.ops.mm(W, flat))

    def init_state(self, x0: dict) -> dict:
        """x0 on every worker and zero momentum."""
        K = self.t["workers"]
        x = {n: v.expand((K,) + tuple(v.shape)).clone() for n, v in x0.items()}
        return {"x": x, "m": {n: torch.zeros_like(v) for n, v in x.items()}}

    def exchange(self, state: dict):
        self.mix(state["x"])

    def extra_readings(self, state: dict, x0: dict) -> dict:
        return {}

    def run(self, x0: dict, batches: list, *, drop_exchange=False,
            mask=None) -> dict:
        """Whole rounds from the one-worker ``x0`` on ``batches`` (one dict
        of K-stacked tokens and labels a step, p a round)."""
        p = self.t["p"]
        if len(batches) % p:
            raise ValueError(f"{len(batches)} steps is no whole round of {p}")
        state = self.init_state(x0)
        losses, grad1 = [], None
        for r in range(len(batches) // p):
            lv, g1 = self.local_steps(state["x"], state["m"],
                                      batches[r * p:(r + 1) * p], mask)
            losses += lv
            grad1 = grad1 or g1
            if not drop_exchange:
                self.exchange(state)
        readings = {"loss": losses, "grad1": grad1,
                    "change": change_norms(state["x"], x0),
                    "momentum": leaf_norms(state["m"])}
        readings.update(self.extra_readings(state, x0))
        return readings
