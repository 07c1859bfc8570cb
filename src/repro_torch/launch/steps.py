"""Greedy prefill and decode steps around ``models.model``.

Counterpart of ``src/repro/launch/steps.py`` (``make_prefill_step`` :148,
``make_slot_prefill_step`` :163, ``make_serve_step`` :189) without a mesh:
each step is the model call plus an argmax, run eagerly under
``torch.inference_mode()`` (the JAX package jits them).  ``torch.argmax``
returns the first of equal maxima, as ``jnp.argmax`` does.
"""

from __future__ import annotations

import torch

from repro_torch.models import model as M


def make_prefill_step(cfg):
    """prefill_step(params, batch, cache) -> (greedy token (B,) int32,
    cache)."""

    @torch.inference_mode()
    def prefill_step(params, batch, cache):
        logits, cache = M.prefill(params, cfg, batch, cache)
        return logits.argmax(-1).to(torch.int32), cache

    return prefill_step


def make_slot_prefill_step(cfg, *, chunked: bool = False):
    """Prefill ONE scheduler slot (a batch=1 cache tree) from position
    ``pos``: slot_prefill_step(params, batch, cache, pos, last_idx) ->
    (first greedy token (1,) int32, cache).  ``last_idx`` is the row of the
    real last prompt token (prompts are right-padded to a fixed width);
    ``chunked=True`` attends against the whole cache."""

    @torch.inference_mode()
    def slot_prefill_step(params, batch, cache, pos: int, last_idx: int):
        logits, cache = M.prefill(params, cfg, batch, cache, pos=pos,
                                  chunked=chunked, last_idx=last_idx)
        return logits.argmax(-1).to(torch.int32), cache

    return slot_prefill_step


def make_serve_step(cfg):
    """One greedy decode step: serve_step(params, cache, tokens (B, 1), pos)
    -> (next tokens (B, 1) int32, cache); pos an int or a (B,) tensor."""

    @torch.inference_mode()
    def serve_step(params, cache, tokens, pos):
        logits, cache = M.decode_step(params, cfg, cache, tokens, pos)
        return logits.argmax(-1)[:, None].to(torch.int32), cache

    return serve_step
