"""Batched serving loop: one prefill, then one decode step per new token.

Port of ``src/repro/serve/serving.py``.  :func:`generate` runs the
prompt through ``Model.prefill_fast`` once, samples a token for every
sequence, and then, for each further token, one ``Model.decode_step``
and a sample, under ``torch.inference_mode()``; the last token is
appended with no decode after it, as in the reference.  Greedy
(``temperature ≤ 0``) is ``argmax``, ties to the lowest index as
``jnp.argmax`` breaks them.  Temperature sampling draws from
``softmax(logits / T)`` with an explicit ``torch.Generator`` (the
logits' device's; seed 0 when none is given): the same distribution as
``jax.random.categorical``, not its bits, as for rand-k
(``core/wire.py``).

:func:`decode_loop` is that control flow over any prefill and decode step,
for the sharded pack (:class:`repro_torch.launch.runtime.ServePack`),
whose ranks each run their rows of the batch and sample on the logits
gathered whole.
"""
from __future__ import annotations

from typing import Callable, Optional

import torch

__all__ = ["decode_loop", "generate", "sample"]


def sample(logits: torch.Tensor, temperature: float,
           generator: Optional[torch.Generator]) -> torch.Tensor:
    """Each row's next token, int32: the argmax (lowest index on a tie)
    at ``temperature ≤ 0``, else a draw from ``softmax(logits / T)``."""
    if temperature <= 0.0:
        return logits.argmax(-1).to(torch.int32)
    probs = torch.softmax(logits.to(torch.float32) / temperature, dim=-1)
    return torch.multinomial(probs, 1, generator=generator)[:, 0].to(
        torch.int32)


def decode_loop(prefill: Callable, step: Callable,
                prompt_tokens: torch.Tensor, max_new: int,
                temperature: float = 0.0,
                generator: Optional[torch.Generator] = None,
                whole: Callable = lambda t: t,
                local: Callable = lambda t: t) -> torch.Tensor:
    """The reference's loop: ``prefill() -> (logits, cache)``, then
    ``step(cache, tokens, pos) -> (logits, cache)`` for each new token but
    the last.  ``whole`` makes the batch's logits from what ``prefill``
    and ``step`` return (a rank's rows), ``local`` a rank's rows of the
    batch's tokens.  Returns the prompt followed by ``max_new`` tokens,
    (b, s + max_new) int32."""
    s = prompt_tokens.shape[1]
    with torch.inference_mode():
        logits, cache = prefill()
        logits = whole(logits)
        if generator is None:
            generator = torch.Generator(device=logits.device).manual_seed(0)
        toks = prompt_tokens.to(torch.int32)
        nxt = sample(logits, temperature, generator)
        for i in range(max_new):
            toks = torch.cat([toks, nxt[:, None]], dim=1)
            if i == max_new - 1:
                break
            logits, cache = step(cache, local(nxt), s + i)
            nxt = sample(whole(logits), temperature, generator)
    return toks


def generate(model, params: dict, prompt_tokens: torch.Tensor, max_new: int,
             temperature: float = 0.0,
             generator: Optional[torch.Generator] = None,
             max_len: Optional[int] = None) -> torch.Tensor:
    """``prompt_tokens`` (b, s) int → (b, s + max_new) int32: one
    ``prefill_fast`` over the prompt, then one ``decode_step`` a token,
    the cache and the RoPE table sized for ``max_len`` (``s + max_new``
    by default)."""
    total = max_len or (prompt_tokens.shape[1] + max_new)
    return decode_loop(
        lambda: model.prefill_fast(params, {"tokens": prompt_tokens},
                                   max_len=total),
        lambda cache, tok, pos: model.decode_step(params, cache, tok, pos,
                                                  max_positions=total),
        prompt_tokens, max_new, temperature, generator)
