"""Synthetic streams: token sequences with a planted cluster chain,
CIFAR-shaped mixture-of-Gaussians images, and Zipf embedding lookups.

Port of ``LMStreamCfg``/``lm_batch``, ``ClassStreamCfg``/``class_batch``
and ``EmbedStreamCfg``/``embed_batch``/``touched_row_mask`` in
``src/repro/data/synthetic.py:34-177``.  Every batch is a pure function of
``(cfg, step)``: its ``torch.Generator`` is seeded from ``(seed, step)``
and the fixed parts (class means, the planted table) from ``seed`` alone,
so every run and every worker is reproducible; the draws run on the
device.  The numbers differ from the reference's threefry stream; the
parity tests feed both packages the reference's batches.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from repro_torch import resolve_device

__all__ = ["LMStreamCfg", "lm_batch", "ClassStreamCfg", "class_batch",
           "worker_class_probs", "EmbedStreamCfg", "embed_batch",
           "touched_row_mask"]


@dataclasses.dataclass(frozen=True)
class LMStreamCfg:
    vocab: int
    seq_len: int
    batch: int           # per worker
    n_workers: int
    seed: int = 0
    n_clusters: int = 64  # planted bigram clusters (learnable structure)


@dataclasses.dataclass(frozen=True)
class ClassStreamCfg:
    n_classes: int = 10
    image: tuple = (32, 32, 3)
    batch: int = 16              # per worker (paper: 16 for CIFAR-10)
    n_workers: int = 8
    seed: int = 0
    noise: float = 0.8
    dirichlet_alpha: Optional[float] = None  # None = IID


def _generator(device: torch.device, *key: int) -> torch.Generator:
    """A generator on ``device`` seeded from the integer ``key``."""
    seed = int(np.random.SeedSequence(list(key)).generate_state(
        1, np.uint64)[0])
    return torch.Generator(device=device).manual_seed(seed)


def lm_batch(cfg: LMStreamCfg, step: int, device="cuda") -> dict:
    """``{"tokens", "labels"}``, each ``(n_workers, batch, seq_len)`` int32
    on ``device``, the labels the tokens shifted by one.  Each sequence
    walks a chain of clusters, ``(c₀ + t) mod n_clusters``, and keeps the
    chain's cluster with probability 0.8 at each position (else a uniform
    one); a token is its cluster's base ``c·span`` plus uniform noise below
    ``span = max(vocab // n_clusters, 1)``, clipped at ``vocab − 1``."""
    device = resolve_device(device)
    g = _generator(device, cfg.seed, 2, int(step))
    n_c = cfg.n_clusters
    span = max(cfg.vocab // n_c, 1)
    shape = (cfg.n_workers, cfg.batch, cfg.seq_len + 1)
    clusters = torch.randint(0, n_c, shape, generator=g, device=device)
    stay = torch.rand(shape, generator=g, device=device) < 0.8
    idx = torch.arange(cfg.seq_len + 1, device=device)
    chain = (clusters[..., :1] + idx) % n_c
    clusters = torch.where(stay, chain, clusters)
    noise = torch.randint(0, span, shape, generator=g, device=device)
    toks = torch.clamp_max(clusters * span + noise, cfg.vocab - 1).to(
        torch.int32)
    return {"tokens": toks[..., :-1], "labels": toks[..., 1:]}


def worker_class_probs(cfg: ClassStreamCfg, device="cuda") -> torch.Tensor:
    """(n_workers, n_classes) per-worker label marginal: uniform (IID)
    without ``dirichlet_alpha``, else one Dirichlet(α·1) draw per worker,
    fixed by ``cfg.seed`` (drawn on the host)."""
    device = resolve_device(device)
    if cfg.dirichlet_alpha is None:
        return torch.full((cfg.n_workers, cfg.n_classes), 1.0 / cfg.n_classes,
                          device=device)
    rng = np.random.default_rng([cfg.seed, 2000])
    probs = rng.dirichlet(np.full(cfg.n_classes, cfg.dirichlet_alpha),
                          cfg.n_workers)
    return torch.as_tensor(probs, dtype=torch.float32, device=device)


def class_batch(cfg: ClassStreamCfg, step: int, device="cuda") -> dict:
    """``{"images": (n_workers, batch, 32, 32, 3) f32, "labels":
    (n_workers, batch) int64}`` on ``device``."""
    device = resolve_device(device)
    means = torch.randn((cfg.n_classes,) + tuple(cfg.image),
                        generator=_generator(device, cfg.seed, 1000),
                        device=device) * 1.5
    g = _generator(device, cfg.seed, int(step))
    # labels by inverse CDF: one uniform per sample against the cumulative
    # marginal (clamp_max guards a cumsum that rounds below 1)
    cdf = worker_class_probs(cfg, device).cumsum(-1)
    u = torch.rand((cfg.n_workers, cfg.batch), generator=g, device=device)
    labels = torch.searchsorted(cdf, u, right=True).clamp_max(cfg.n_classes - 1)
    noise = torch.randn((cfg.n_workers, cfg.batch) + tuple(cfg.image),
                        generator=g, device=device)
    return {"images": means[labels] + cfg.noise * noise, "labels": labels}


@dataclasses.dataclass(frozen=True)
class EmbedStreamCfg:
    """Zipf embedding lookups: ``batch`` row ids per worker per step, row
    popularity ∝ rank^(−zipf_a), so a few hot rows take most of the
    traffic and a step touches far fewer rows than the table holds."""
    n_rows: int = 16384      # embedding-table rows
    dim: int = 64            # embedding dimension
    batch: int = 64          # lookups per worker per step
    n_workers: int = 8
    seed: int = 0
    zipf_a: float = 1.1      # power-law exponent over row ranks
    noise: float = 0.1       # target observation noise


def embed_batch(cfg: EmbedStreamCfg, step: int, device="cuda") -> dict:
    """``{"ids": (n_workers, batch) int64, "targets": (n_workers, batch)
    f32}`` on ``device``: ids drawn from the Zipf law over row ranks,
    ``target = Σ_dim planted[id] + noise``, a linear readout of a planted
    table fixed by ``cfg.seed``, so the gradient of an embedding table is
    non-zero exactly on the looked-up rows."""
    device = resolve_device(device)
    planted = torch.randn((cfg.n_rows, cfg.dim),
                          generator=_generator(device, cfg.seed, 0, 3000),
                          device=device) * 0.5
    ranks = torch.arange(1, cfg.n_rows + 1, dtype=torch.float32,
                         device=device)
    probs = ranks.pow(-cfg.zipf_a).expand(cfg.n_workers, -1).contiguous()
    g = _generator(device, cfg.seed, 1, int(step))
    ids = torch.multinomial(probs, cfg.batch, replacement=True, generator=g)
    noise = torch.randn((cfg.n_workers, cfg.batch), generator=g,
                        device=device)
    return {"ids": ids, "targets": planted[ids].sum(-1) + cfg.noise * noise}


def touched_row_mask(ids: torch.Tensor, n_rows: int) -> torch.Tensor:
    """(n_rows,) bool: the table rows a batch of lookups touches, exactly
    the rows an embedding gradient (and so the sparse wire) is non-zero
    on."""
    mask = torch.zeros((n_rows,), dtype=torch.bool, device=ids.device)
    mask[ids.reshape(-1)] = True
    return mask
