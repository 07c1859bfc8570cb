"""AdamW (decoupled weight decay) as plain tensor functions.

Counterpart of ``src/repro/optim/adamw.py`` (:19-101), with its global-norm
clipping, bias correction and decay placement (``torch.optim.AdamW`` has
neither the clipping nor the same update order).  Params, grads and the
moments are flat lists of tensors; the update returns NEW tensors and never
writes into the caller's params.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Callable, List, NamedTuple

import torch


class AdamWState(NamedTuple):
    step: int
    m: List[torch.Tensor]
    v: List[torch.Tensor]


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: float = 1e-4
    b1: float = 0.9
    b2: float = 0.999
    eps: float = 1e-8
    weight_decay: float = 0.0
    grad_clip: float = 1.0


def init(params: List[torch.Tensor]) -> AdamWState:
    zeros = [torch.zeros(p.shape, dtype=torch.float32, device=p.device)
             for p in params]
    return AdamWState(step=0, m=zeros, v=[z.clone() for z in zeros])


def global_norm(tensors: List[torch.Tensor]) -> torch.Tensor:
    return torch.sqrt(sum(torch.sum(torch.square(x.float()))
                          for x in tensors) + 1e-20)


def update(grads: List[torch.Tensor], state: AdamWState,
           params: List[torch.Tensor], cfg: AdamWConfig, lr_scale=1.0):
    """Returns (new_params, new_state, metrics); the grad norm stays on
    the device (no host sync)."""
    gnorm = global_norm(grads)
    clip = (torch.clamp(cfg.grad_clip / torch.clamp(gnorm, min=1e-12),
                        max=1.0) if cfg.grad_clip else 1.0)
    step = state.step + 1
    b1t = 1.0 - cfg.b1 ** step
    b2t = 1.0 - cfg.b2 ** step
    lr = cfg.lr * lr_scale
    new_p, new_m, new_v = [], [], []
    for g, m, v, p in zip(grads, state.m, state.v, params):
        g = g.float() * clip
        m = cfg.b1 * m + (1 - cfg.b1) * g
        v = cfg.b2 * v + (1 - cfg.b2) * torch.square(g)
        upd = (m / b1t) / (torch.sqrt(v / b2t) + cfg.eps)
        if cfg.weight_decay:
            upd = upd + cfg.weight_decay * p.float()
        new_p.append((p.float() - lr * upd).to(p.dtype))
        new_m.append(m)
        new_v.append(v)
    return new_p, AdamWState(step, new_m, new_v), {"grad_norm": gnorm}


def update_with_schedule(grads, state: AdamWState, params, cfg: AdamWConfig,
                         sched: Callable[[int], float]):
    """``update`` with the lr multiplier read from the step counter BEFORE
    this step (``sched(state.step)``), as the JAX package does."""
    return update(grads, state, params, cfg, sched(state.step))


def cosine_schedule(base_lr: float, total_steps: int,
                    warmup_steps: int = 0, final_frac: float = 0.0
                    ) -> Callable[[int], float]:
    """lr multiplier: linear warmup then cosine decay to final_frac."""

    def sched(step: int) -> float:
        if step < warmup_steps:
            return step / max(warmup_steps, 1)
        prog = (step - warmup_steps) / max(total_steps - warmup_steps, 1)
        prog = min(max(prog, 0.0), 1.0)
        return final_frac + (1 - final_frac) * 0.5 * (1 + math.cos(math.pi
                                                                  * prog))

    return sched
