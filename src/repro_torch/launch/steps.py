"""Train, prefill and decode steps around ``models.model``.

Counterpart of ``src/repro/launch/steps.py`` without a mesh:
``TrainState`` / ``init_train_state`` (:30-40) and ``make_train_step``
(:118-145), then ``make_prefill_step`` :148, ``make_slot_prefill_step``
:163 and ``make_serve_step`` :189.  The train step takes the loss and its
gradients over every leaf of the param tree with ``torch.autograd`` and
updates through ``optim.adamw.update``; its metrics stay on the device (no
host sync in the step).  The serving steps are the model call plus an
argmax, run eagerly under ``torch.inference_mode()`` (the JAX package jits
them).  ``torch.argmax`` returns the first of equal maxima, as
``jnp.argmax`` does.  Sharding plans (``train_shardings``) come with data
parallelism.
"""

from __future__ import annotations

from typing import Any, Callable, NamedTuple, Optional

import numpy as np
import torch
from torch.profiler import record_function

from repro_torch.models import model as M
from repro_torch.optim import adamw
from repro_torch.tree import flatten, tree_leaves, tree_map, unflatten

PyTree = Any


class TrainState(NamedTuple):
    """Params, AdamW state (its ``m`` and ``v`` trees mirror the params)
    and the step count (a Python int: reading it never syncs)."""
    params: PyTree
    opt: adamw.AdamWState
    step: int


def _zeros_like_tree(params):
    return tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                          device=p.device), params)


def train_state_for(params) -> TrainState:
    """Step 0 from ``params``: zero fp32 moments on the params' devices."""
    return TrainState(params, adamw.AdamWState(
        0, _zeros_like_tree(params), _zeros_like_tree(params)), 0)


def init_train_state(cfg, seed: int = 0, *, device=None) -> TrainState:
    """Fresh params (``M.init_params(cfg, seed)``) on ``device`` (default:
    the card), zero moments, step 0."""
    return train_state_for(M.init_params(cfg, seed, device=device))


def state_for_checkpoint(state: TrainState) -> TrainState:
    """The state as the JAX package's ``TrainState`` saves: both step
    counts as 0-d int32 arrays (leaves are named by field)."""
    return TrainState(state.params, adamw.AdamWState(
        np.int32(state.opt.step), state.opt.m, state.opt.v),
        np.int32(state.step))


def state_from_checkpoint(saved: TrainState) -> TrainState:
    """Inverse of :func:`state_for_checkpoint` on a restored tree."""
    return TrainState(saved.params, adamw.AdamWState(
        int(saved.opt.step), saved.opt.m, saved.opt.v), int(saved.step))


def loss_and_grads(cfg, params, batch):
    """(loss, {"ce", "aux"}, grads): ``M.loss_fn`` and its gradient with
    respect to every leaf of ``params`` (a tree like it; zeros where a
    leaf does not reach the loss), all left on the device."""
    leaves, treedef = flatten(params)
    live = [t.detach().requires_grad_() for t in leaves]
    with record_function("train_step/forward"):
        loss, metrics = M.loss_fn(unflatten(treedef, live), cfg, batch)
    grads = torch.autograd.grad(loss, live, allow_unused=True)
    grads = [torch.zeros_like(t) if g is None else g
             for t, g in zip(live, grads)]
    return (loss.detach(), {k: v.detach() for k, v in metrics.items()},
            unflatten(treedef, grads))


def make_train_step(cfg, *, optimizer: Optional[adamw.AdamWConfig] = None,
                    lr_schedule: Optional[Callable[[int], float]] = None):
    """train_step(state, batch) -> (new state, metrics {"loss", "ce",
    "aux", "grad_norm"}): forward, backward and one AdamW update (default
    lr 3e-4, weight decay 0.01), the lr multiplier
    ``lr_schedule(state.step)`` read BEFORE the step, as in the JAX
    package.  Returns new tensors; the caller drops the old state."""
    ocfg = optimizer or adamw.AdamWConfig(lr=3e-4, weight_decay=0.01)

    def train_step(state: TrainState, batch):
        with record_function("train_step/loss_and_grads"):
            loss, metrics, grads = loss_and_grads(cfg, state.params, batch)
        lr_scale = (lr_schedule(state.step) if lr_schedule is not None
                    else 1.0)
        with record_function("train_step/adamw"):
            leaves, treedef = flatten(state.params)
            opt = adamw.AdamWState(state.opt.step, tree_leaves(state.opt.m),
                                   tree_leaves(state.opt.v))
            new_p, opt, om = adamw.update(tree_leaves(grads), opt, leaves,
                                          ocfg, lr_scale)
        new_opt = adamw.AdamWState(opt.step, unflatten(treedef, opt.m),
                                   unflatten(treedef, opt.v))
        metrics = dict(metrics, loss=loss, **om)
        return (TrainState(unflatten(treedef, new_p), new_opt,
                           state.step + 1), metrics)

    return train_step


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
