"""The initial weights x0, made on the device from ``--seed``.

One standard normal draw over every element of one worker, clipped at
±2 (a stand-in for a truncated normal), then each leaf scaled or set by
its reference's ``init_rule``.  All K workers start from the same x0
(Algorithm 1's input): :func:`stack` copies it K times in one call.  The
leaves are views into one buffer, so the whole of x0 is a few large
calls on the card, whatever the number of leaves.  The program and the
reference are handed the same x0.
"""
from __future__ import annotations

import math

import torch

from bench.streams import _generator


def _views(buf: torch.Tensor, shapes: dict, lead: tuple) -> dict:
    out, off = {}, 0
    for name, shape in shapes.items():
        n = math.prod(shape) if shape else 1
        out[name] = buf[..., off:off + n].view(lead + tuple(shape))
        off += n
    return out


def make(shapes: dict, init_rule, seed: int, device) -> dict:
    """One worker's x0 (f32) of ``shapes``; ``init_rule(name, shape)``
    gives ``("normal", std)``, ``("const", value)`` or ``("values",
    tensor)`` for each leaf."""
    total = sum(math.prod(s) if s else 1 for s in shapes.values())
    flat = torch.randn(total, generator=_generator(device, seed, 1),
                       device=device, dtype=torch.float32).clamp_(-2.0, 2.0)
    leaves = _views(flat, shapes, ())
    for name, shape in shapes.items():
        kind, arg = init_rule(name, shape)
        if kind == "normal":
            leaves[name].mul_(arg)
        elif kind == "const":
            leaves[name].fill_(arg)
        elif kind == "values":
            leaves[name].copy_(arg)
        else:
            raise ValueError(f"{name}: init kind {kind!r}")
    return leaves


def stack(x0: dict, workers: int) -> dict:
    """x0 copied to ``workers`` stacked workers, the leaves views into one
    ``(workers, n)`` buffer."""
    shapes = {n: tuple(t.shape) for n, t in x0.items()}
    first = next(iter(x0.values()))
    flat = first.new_empty(sum(t.numel() for t in x0.values()))
    off = 0
    for t in x0.values():
        flat[off:off + t.numel()].copy_(t.reshape(-1))
        off += t.numel()
    return _views(flat.expand(workers, -1).contiguous(), shapes, (workers,))
