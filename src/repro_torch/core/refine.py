"""Block-level local refinement (Alg. 2 step 9, App. B.2).

Counterpart of ``src/repro/core/refine.py::refine_unit`` (:201).  Jointly
optimizes every floating leaf of the unit — the factor pairs {U_j, V_j} and
the norm scales — to minimize MSE(L_i(X), L'_i(X')): the original block
outputs are the anchors, the shifted inputs are what the compressed block
sees.  AdamW with global-norm clipping 1.0 and a cosine schedule with linear
warmup; gradients come from ``torch.autograd`` through the unit forward
(the factorized linears' backward is ``kernels.ops``' autograd rule).

The port runs a per-step loop (the JAX package's loop path; its scanned
single-dispatch schedule is a JAX dispatch device).  ``target_mse`` > 0 stops
after the first epoch whose mean loss is at or below it.
"""

from __future__ import annotations

from typing import Callable, Sequence

import torch

from repro_torch.optim import adamw
from repro_torch.tree import flatten, unflatten


def refine_unit(apply_fn: Callable, params, xp_batches: Sequence,
                y_batches: Sequence, *, epochs: int = 25, lr: float = 1e-4,
                warmup_frac: float = 0.1, weight_decay: float = 0.0,
                target_mse: float = 0.0):
    """apply_fn(params, xp, aux) -> block output.

    xp_batches: list of (shifted_input, aux) tuples; y_batches: anchor
    outputs (any float dtype; the loss upcasts to fp32).

    Returns (refined_params, history) — history carries
    ``pre_refine_mse``/``post_refine_mse``, per-epoch ``losses``, the
    optimizer ``steps`` applied, ``mode`` ("loop") and ``dispatches``: the
    unit forwards issued from the host (loss evaluations plus optimizer
    steps), the count the JAX package's loop path reports.
    """
    n_batches = len(xp_batches)
    total_steps = max(1, epochs * n_batches)
    warmup_steps = max(1, int(warmup_frac * total_steps))
    ocfg = adamw.AdamWConfig(lr=lr, weight_decay=weight_decay, grad_clip=1.0)
    sched = adamw.cosine_schedule(1.0, total_steps, warmup_steps=warmup_steps)
    leaves, treedef = flatten(params)
    history = {"dispatches": 0, "mode": "loop", "losses": [], "steps": 0}

    def loss_of(ls, i):
        xp, aux = xp_batches[i]
        out = apply_fn(unflatten(treedef, ls), xp, aux)
        return torch.mean(torch.square(out.float() - y_batches[i].float()))

    def mean_loss(ls) -> float:
        with torch.no_grad():
            tot = torch.zeros((), dtype=torch.float32,
                              device=y_batches[0].device)
            for i in range(n_batches):
                history["dispatches"] += 1
                tot = tot + loss_of(ls, i)
        return float(tot) / n_batches

    history["pre_refine_mse"] = mean_loss(leaves)
    state = adamw.init(leaves)
    with torch.enable_grad():
        for _ in range(epochs):
            ep_loss = torch.zeros((), dtype=torch.float32,
                                  device=y_batches[0].device)
            for i in range(n_batches):
                history["dispatches"] += 1
                live = [leaf.detach().requires_grad_(True) for leaf in leaves]
                loss = loss_of(live, i)
                grads = torch.autograd.grad(loss, live)
                leaves, state, _ = adamw.update_with_schedule(
                    grads, state, [leaf.detach() for leaf in live], ocfg,
                    sched)
                ep_loss = ep_loss + loss.detach()
            history["losses"].append(float(ep_loss) / n_batches)
            history["steps"] += n_batches
            if target_mse > 0.0 and history["losses"][-1] <= target_mse:
                break
    history["post_refine_mse"] = mean_loss(leaves)
    return unflatten(treedef, leaves), history
