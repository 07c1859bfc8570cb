"""Fault-tolerant training driver on one card.

Counterpart of ``src/repro/launch/train.py`` (:42-145) without a mesh:

* checkpoint / restart: the latest complete checkpoint of ``ckpt_dir``
  (format 3, the JAX package's ``TrainState`` names, so either package
  reads the other's) is restored and the data resumes at its step;
* deterministic per-step data (``repro_torch.data``): a restarted run
  regenerates exactly the batch it stopped at;
* preemption: SIGTERM finishes the current step, saves blocking and exits
  42 ("reschedule me"); the previous SIGTERM handler is back once ``train``
  returns;
* a per-step deadline: a step slower than ``step_deadline_s`` (host time,
  as the JAX driver measures its dispatch) is treated as a straggler: save
  blocking and return ``{"aborted_straggler": True, "step": step}``.

A save that must block first waits for the one in flight, so two writers
never share a step's directory.  As in the JAX package, the lr multiplier
is a cosine schedule with ``max(1, steps // 20)`` warmup steps read at the
step count before each step, so the first step's is 0 and it moves only
the moments; and ``grad_compression`` is accepted and not applied.

    python -m repro_torch.launch.train --arch qwen3-0.6b --smoke --steps 50
    python -m repro_torch.launch.train --smoke --device cpu   # no card
"""

from __future__ import annotations

import argparse
import signal
import sys
import time

from repro_torch.checkpoint import CheckpointManager
from repro_torch.configs import ALL_ARCHS, get_config, get_smoke_config
from repro_torch.data import make_batch_iterator
from repro_torch.device import resolve_device
from repro_torch.launch import steps as S
from repro_torch.optim import adamw


class PreemptionGuard:
    """SIGTERM -> finish the current step, checkpoint, exit(42).
    ``close`` puts the previous handler back."""

    def __init__(self):
        self.preempted = False
        self._previous = signal.signal(signal.SIGTERM, self._handler)

    def _handler(self, *_):
        self.preempted = True

    def close(self):
        signal.signal(signal.SIGTERM, self._previous)


def train(cfg, *, steps: int, batch: int, seq_len: int, ckpt_dir: str,
          ckpt_every: int = 50, lr: float = 3e-4,
          grad_compression: bool = False, step_deadline_s: float = 0.0,
          log_every: int = 10, seed: int = 0, device=None):
    """Train ``cfg`` from seed ``seed`` (or the latest checkpoint in
    ``ckpt_dir``) to ``steps`` steps of ``batch`` x ``seq_len`` tokens,
    AdamW (lr ``lr``, weight decay 0.01) on ``device`` (default: the
    card).  Saves every ``ckpt_every`` steps and at the last; prints the
    loss every ``log_every`` steps, the loop's only host sync.  Returns
    (state, {"losses": [...], "step": steps}), or the straggler record.

    ``grad_compression`` (int8 with error feedback, ``optim.compression``)
    is accepted and not applied, as in the JAX package: it would shrink a
    data-parallel all-reduce, and one card has none."""
    dev = resolve_device(device)
    guard = PreemptionGuard()
    try:
        return _train(cfg, steps, batch, seq_len, ckpt_dir, ckpt_every, lr,
                      step_deadline_s, log_every, seed, dev, guard)
    finally:
        guard.close()


def _train(cfg, steps, batch, seq_len, ckpt_dir, ckpt_every, lr,
           step_deadline_s, log_every, seed, dev, guard):
    mgr = CheckpointManager(ckpt_dir)
    sched = adamw.cosine_schedule(1.0, steps,
                                  warmup_steps=max(1, steps // 20))
    step_fn = S.make_train_step(
        cfg, optimizer=adamw.AdamWConfig(lr=lr, weight_decay=0.01),
        lr_schedule=sched)

    # ---- init or restore ------------------------------------------------
    state = S.init_train_state(cfg, seed, device=dev)
    start_step = 0
    if mgr.latest_step() is not None:
        start_step, saved = mgr.restore(None, S.state_for_checkpoint(state),
                                        device=dev)
        state = S.state_from_checkpoint(saved)
        print(f"[train] restored step {start_step} from {ckpt_dir}")

    def save(step, *, blocking=False):
        if blocking:
            mgr.wait()
        mgr.save(step, S.state_for_checkpoint(state), blocking=blocking)

    data = make_batch_iterator(cfg, batch, seq_len, seed=seed,
                               start_step=start_step, device=dev)
    losses = []
    for step in range(start_step, steps):
        t0 = time.time()
        b = next(data)
        state, metrics = step_fn(state, b)
        dt = time.time() - t0
        if step_deadline_s and dt > step_deadline_s:
            print(f"[train] step {step} exceeded deadline "
                  f"({dt:.1f}s > {step_deadline_s}s) — treating as "
                  "straggler; checkpointing and aborting for reschedule")
            save(step + 1, blocking=True)
            return state, {"aborted_straggler": True, "step": step}
        if (step + 1) % ckpt_every == 0 or step == steps - 1:
            save(step + 1)
        if (step + 1) % log_every == 0:
            # repro-check: allow[host-sync-loop] — the logged loss, read every log_every steps only
            loss = float(metrics["loss"])
            losses.append(loss)
            print(f"[train] step {step + 1}/{steps} loss {loss:.4f} "
                  f"({dt * 1e3:.0f} ms)", flush=True)
        if guard.preempted:
            print("[train] preemption signal — checkpointing and exiting 42",
                  flush=True)
            save(step + 1, blocking=True)
            sys.exit(42)
    mgr.wait()
    return state, {"losses": losses, "step": steps}


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", choices=ALL_ARCHS, default="qwen3-0.6b")
    ap.add_argument("--smoke", action="store_true",
                    help="use the reduced config (fp32, CPU-runnable)")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq-len", type=int, default=128)
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--ckpt-dir", default="artifacts/ckpt")
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--grad-compression", action="store_true")
    ap.add_argument("--step-deadline-s", type=float, default=0.0)
    ap.add_argument("--device", default=None,
                    help="torch device (default: the card; cpu runs the "
                    "plain PyTorch versions)")
    args = ap.parse_args(argv)

    cfg = get_smoke_config(args.arch) if args.smoke else get_config(args.arch)
    if args.smoke:
        cfg = cfg.replace(dtype="float32")
    return train(cfg, steps=args.steps, batch=args.batch,
                 seq_len=args.seq_len, ckpt_dir=args.ckpt_dir, lr=args.lr,
                 ckpt_every=args.ckpt_every,
                 grad_compression=args.grad_compression,
                 step_deadline_s=args.step_deadline_s, device=args.device)


if __name__ == "__main__":
    main()
