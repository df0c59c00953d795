"""The four assigned input shapes, and random batches in a model's input mode.

Port of ``src/repro/configs/shapes.py:14-88``.  The reference's
``ShapeDtypeStruct`` records (``_batch_struct``, ``train_batch_specs``)
are tensors on the ``meta`` device here: a shape and a dtype, no storage.
"""
from __future__ import annotations

import dataclasses
from typing import Dict

import torch

from repro_torch import resolve_device
from repro_torch.configs.base import ModelCfg

__all__ = ["InputShape", "SHAPES", "train_batch_arrays", "train_batch_specs",
           "torch_dtype"]


@dataclasses.dataclass(frozen=True)
class InputShape:
    name: str
    seq_len: int
    global_batch: int
    kind: str  # "train" | "prefill" | "decode"


SHAPES: Dict[str, InputShape] = {
    "train_4k": InputShape("train_4k", 4_096, 256, "train"),
    "prefill_32k": InputShape("prefill_32k", 32_768, 32, "prefill"),
    "decode_32k": InputShape("decode_32k", 32_768, 128, "decode"),
    "long_500k": InputShape("long_500k", 524_288, 1, "decode"),
}


def torch_dtype(name: str) -> torch.dtype:
    """The torch dtype of a config's dtype string (``"float32"``,
    ``"bfloat16"``, …)."""
    dtype = getattr(torch, name, None)
    if not isinstance(dtype, torch.dtype):
        raise ValueError(f"unknown dtype {name!r}")
    return dtype


def _batch_struct(cfg: ModelCfg, batch: int, seq: int,
                  with_labels: bool) -> dict:
    """One worker's batch as meta tensors in the model's input mode: int32
    ``tokens`` (b, seq), ``embeds`` (b, seq, d) in the compute dtype, or
    ``patch_embeds`` (b, min(n_patches, seq // 2), d) and the tokens after
    them; int32 ``labels`` over the text positions with ``with_labels``."""
    cd = torch_dtype(cfg.compute_dtype)

    def meta(shape, dtype):
        return torch.empty(shape, dtype=dtype, device="meta")

    out = {}
    npatch = min(cfg.n_patches, seq // 2) if cfg.input_mode == "vlm" else 0
    if cfg.input_mode == "tokens":
        out["tokens"] = meta((batch, seq), torch.int32)
    elif cfg.input_mode == "embeds":
        out["embeds"] = meta((batch, seq, cfg.d_model), cd)
    elif cfg.input_mode == "vlm":
        out["patch_embeds"] = meta((batch, npatch, cfg.d_model), cd)
        out["tokens"] = meta((batch, seq - npatch), torch.int32)
    if with_labels:
        out["labels"] = meta((batch, seq - npatch), torch.int32)
    return out


def train_batch_specs(cfg: ModelCfg, shape: InputShape,
                      n_workers: int) -> dict:
    """The batch of ``shape`` stacked over ``n_workers``, ``(n_workers,
    global_batch / n_workers, ...)``, as meta tensors; labels for a train
    shape only."""
    if shape.global_batch % n_workers:
        raise ValueError(f"global_batch {shape.global_batch} % workers "
                         f"{n_workers}")
    base = _batch_struct(cfg, shape.global_batch // n_workers, shape.seq_len,
                         with_labels=shape.kind == "train")
    return {k: v.unsqueeze(0).expand((n_workers,) + tuple(v.shape))
            for k, v in base.items()}


def train_batch_arrays(cfg: ModelCfg, n_workers: int, per_batch: int,
                       seq: int, generator: torch.Generator,
                       with_labels: bool = True, device="cuda") -> dict:
    """Concrete random batch with the structure of the model's input mode,
    stacked ``(n_workers, per_batch, ...)``: int32 ``tokens`` and
    ``labels`` uniform over the vocabulary, normal ``embeds`` or
    ``patch_embeds`` in the compute dtype.  Drawn from ``generator`` (on
    its own device) and moved to ``device``."""
    device = resolve_device(device)
    cd = torch_dtype(cfg.compute_dtype)
    gdev = generator.device

    def tokens(shape):
        return torch.randint(0, cfg.vocab, shape, generator=generator,
                             device=gdev, dtype=torch.int32).to(device)

    def normal(shape):
        return torch.randn(shape, generator=generator, device=gdev,
                           dtype=torch.float32).to(device=device, dtype=cd)

    lead = (n_workers, per_batch)
    out = {}
    if cfg.input_mode == "tokens":
        out["tokens"] = tokens(lead + (seq,))
    elif cfg.input_mode == "embeds":
        out["embeds"] = normal(lead + (seq, cfg.d_model))
    elif cfg.input_mode == "vlm":
        npatch = min(cfg.n_patches, seq // 2)
        out["patch_embeds"] = normal(lead + (npatch, cfg.d_model))
        out["tokens"] = tokens(lead + (seq - npatch,))
    if with_labels:
        ls = seq if cfg.input_mode != "vlm" else seq - min(cfg.n_patches,
                                                           seq // 2)
        out["labels"] = tokens(lead + (ls,))
    return out
