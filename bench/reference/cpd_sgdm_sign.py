"""CPD-SGDM's first rounds (paper Algorithm 2) with the scaled-sign
compressor, worker by worker, in f32.

The local steps are PD-SGDM's (:mod:`bench.reference.pd_sgdm`); each round
ends with, per worker k, from x̂ = x0 on every worker at the start
(Algorithm 2's input), so that the first round's consensus moves nothing
and the second's does::

    x_k ← x_k + γ Σⱼ w_kj (x̂_j − x̂_k)        (consensus)
    q_k = Q(x_k − x̂_k)                        (compress)
    x̂_k ← x̂_k + q_k                           (every copy of x̂_k)

Q is the blockwise scaled sign: each leaf, flattened, is cut into blocks
of 1,024 elements (the last one short), and each element of a block is
sent as ``±scale`` with ``scale`` the mean |value| over the block's valid
elements and ``+`` for a value ≥ 0.  The readings add each leaf's norm of
``x̂ − x0``.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from bench.reference.pd_sgdm import Round as PDRound
from bench.reference.pd_sgdm import change_norms, ring_matrix

BLOCK = 1024


def scaled_sign(d: torch.Tensor) -> torch.Tensor:
    """Q of a K-stacked leaf ``d`` (K, ...), block by block."""
    K = d.shape[0]
    flat = d.reshape(K, -1)
    n = flat.shape[1]
    rows = -(-n // BLOCK)
    blocks = F.pad(flat, (0, rows * BLOCK - n)).reshape(K, rows, BLOCK)
    counts = torch.full((rows,), float(BLOCK), device=d.device)
    counts[-1] = n - (rows - 1) * BLOCK
    scale = blocks.abs().sum(-1) / counts
    q = torch.where(blocks >= 0, scale[..., None], -scale[..., None])
    return q.reshape(K, -1)[:, :n].reshape(d.shape)


class Round(PDRound):
    def init_state(self, x0: dict) -> dict:
        state = super().init_state(x0)
        state["xhat"] = {n: v.clone() for n, v in state["x"].items()}
        return state

    def exchange(self, state: dict):
        x, xhat = state["x"], state["xhat"]
        W = ring_matrix(self.t["workers"], self.t["self_weight"],
                        next(iter(x.values())).device)
        gamma = self.t["gamma"]
        with torch.no_grad():
            for n, v in x.items():
                h = xhat[n]
                mixed = self.ops.mm(W, h.reshape(v.shape[0], -1))
                v.add_(gamma * (mixed.reshape(v.shape) - h))
                h.add_(scaled_sign(v - h))

    def extra_readings(self, state: dict, x0: dict) -> dict:
        return {"xhat": change_norms(state["xhat"], x0)}
