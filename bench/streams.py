"""The general traffic generator: token batches of a training mix.

A traffic file (``traffic/<name>.json``) gives the sizes (``seq``,
``batch`` a worker, ``workers``) and the stream's parameters; this module
draws the batches on the device from ``--seed``.  The stream is a copy of
the port's clustered synthetic stream (``repro_torch/data/synthetic.py``,
``lm_batch``): each sequence walks a chain of ``n_clusters`` clusters,
keeps the chain's cluster with probability ``stay`` at each position
(else a uniform one), and a token is its cluster's base plus uniform noise
below the cluster's span, clipped at ``vocab − 1``.

Steps are drawn in chunks of ``CHUNK_STEPS`` from a generator seeded by
``(seed, chunk)``, so step t's batch is the same whatever number of steps
a run stages, and every step and worker draws rows of its own.
"""
from __future__ import annotations

import numpy as np
import torch

CHUNK_STEPS = 16


def _generator(device, *key: int) -> torch.Generator:
    """A generator on ``device`` seeded from the integers ``key`` (any
    size and sign)."""
    words = [int(k) & (2 ** 64 - 1) for k in key]
    seed = int(np.random.SeedSequence(words).generate_state(1, np.uint64)[0])
    return torch.Generator(device=device).manual_seed(seed)


def _chunk(traffic: dict, vocab: int, seed: int, c: int, device):
    """``(CHUNK_STEPS, workers, batch, seq + 1)`` int32 tokens of chunk c."""
    n_c = traffic["n_clusters"]
    span = max(vocab // n_c, 1)
    shape = (CHUNK_STEPS, traffic["workers"], traffic["batch"],
             traffic["seq"] + 1)
    g = _generator(device, seed, 2, c)
    clusters = torch.randint(0, n_c, shape, generator=g, device=device)
    stay = torch.rand(shape, generator=g, device=device) < traffic["stay"]
    idx = torch.arange(shape[-1], device=device)
    chain = (clusters[..., :1] + idx) % n_c
    clusters = torch.where(stay, chain, clusters)
    noise = torch.randint(0, span, shape, generator=g, device=device)
    return torch.clamp_max(clusters * span + noise, vocab - 1).to(torch.int32)


class TokenStream:
    """Steps ``[0, steps)`` of a cell's token stream staged on ``device``;
    ``feed(offset)`` is a ``batch_fn`` whose step t is stream step
    ``offset + t``: it only indexes the staged tokens."""

    def __init__(self, traffic: dict, vocab: int, seed: int, steps: int,
                 device):
        if traffic["stream"] != "clustered":
            raise ValueError(f"no generator for stream {traffic['stream']!r}")
        n = -(-steps // CHUNK_STEPS)
        self.tokens = torch.cat([_chunk(traffic, vocab, seed, c, device)
                                 for c in range(n)])[:steps]

    @property
    def steps(self) -> int:
        return self.tokens.shape[0]

    def batch(self, t: int) -> dict:
        """Step t: ``{"tokens", "labels"}``, each (workers, batch, seq)."""
        if not 0 <= t < self.steps:
            raise IndexError(f"step {t} outside the {self.steps} staged")
        toks = self.tokens[t]
        return {"tokens": toks[..., :-1], "labels": toks[..., 1:]}

    def feed(self, offset: int):
        return lambda t: self.batch(offset + t)
