"""Arch-zoo conformance harness of the port: compress → checkpoint → serve.

Counterpart of ``src/repro/core/zoo.py``.  AA-SVD's claim is functional
equivalence of the compressed model; this module proves the compressed
artifact survives the port's production path —
``pipeline.compress_model`` → ``checkpoint.CheckpointManager`` save and
restore → ``launch.serve.Server.from_checkpoint`` → decode — for every
registered arch, at smoke scale.  The contract per arch (``roundtrip``):

* **bit parity** — the checkpointed-and-restored params are bit-identical
  to the in-memory compressed params (dtype, shape and bytes, so ``-0.0``
  is not ``0.0``), including the zero-masked per-expert bank tails and the
  factorized latent-KV factor pairs; the re-sliced export
  (``reslice_banks=True``) must restore bit-identical too.
* **token parity** — a ``Server`` built from either checkpoint decodes
  token for token against the in-memory server.
* **envelopes** — smoke perplexity ratio (compressed / dense) and the
  restored server's decode throughput against the per-arch envelopes
  checked in at ``tests/conformance/envelopes.json`` (set for the JAX
  package on a CPU runner).

Data comes from ``repro_torch.data`` with fixed seeds (torch generators:
the numbers differ from ``jax.random``'s, the distributions are the same),
so the quality numbers are regression anchors, not paper-scale
measurements.  Everything runs on ``device`` (default: the card).
"""

from __future__ import annotations

import json
import time
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.configs import get_smoke_config
from repro_torch.core.pipeline import CompressConfig, compress_model
from repro_torch.data import (calibration_set, make_batch_iterator,
                              synthetic_tokens)
from repro_torch.device import resolve_device
from repro_torch.models import model as M

PyTree = Any

# One fixed recipe for every arch: aggressive enough that every unit kind
# actually factorizes, small enough that the 11-arch matrix stays CI-sized.
SMOKE_COMPRESS = dict(ratio=0.6, rank_multiple=1, microbatch=2,
                      calib_mode="fused", refine_epochs=1)
SMOKE_CALIB = dict(n=4, seq_len=32)
SMOKE_PROMPTS = dict(batch=2, prompt_len=16)
SMOKE_DECODE_STEPS = 12


def smoke_cfg(arch: str):
    """Smoke config pinned to float32 — conformance compares bits, and a
    deterministic dtype keeps the parity contract platform-independent."""
    return get_smoke_config(arch).replace(dtype="float32")


def smoke_inputs(cfg, *, seed: int = 7, device=None
                 ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """Prompts + modality extras matching the arch's frontend, drawn from a
    CPU ``torch.Generator`` seeded with ``seed``, on ``device``."""
    dev = resolve_device(device)
    gen = torch.Generator().manual_seed(seed)
    b, plen = SMOKE_PROMPTS["batch"], SMOKE_PROMPTS["prompt_len"]
    prompts = synthetic_tokens(gen, b, plen, cfg.vocab_size)
    extras: Dict[str, torch.Tensor] = {}
    if cfg.frontend == "vision":
        extras["patches"] = 0.02 * torch.randn(
            b, cfg.num_patches, cfg.d_model, generator=gen)
    if cfg.frontend == "audio":
        extras["frames"] = 0.02 * torch.randn(
            b, cfg.encoder_seq_len, cfg.d_model, generator=gen)
    return prompts.to(dev), {k: v.to(dev) for k, v in extras.items()}


def compress_smoke(arch: str, *, seed: int = 0, device=None):
    """Compress the arch at smoke scale on ``device``.  Returns
    ``(cfg, dense_params, compressed_params, report)``."""
    dev = resolve_device(device)
    cfg = smoke_cfg(arch)
    params = M.init_params(cfg, seed, device=dev)
    calib = calibration_set(cfg, SMOKE_CALIB["n"], SMOKE_CALIB["seq_len"],
                            device=dev)
    comp, report = compress_model(params, cfg, calib,
                                  CompressConfig(**SMOKE_COMPRESS),
                                  device=dev)
    return cfg, params, comp, report


def smoke_ppl(params, cfg, *, seed: int = 99, batches: int = 2,
              device=None) -> float:
    data = make_batch_iterator(cfg, 8, 64, seed=seed, device=device)
    tot = 0.0
    with torch.no_grad():
        for _ in range(batches):
            # repro-check: allow[host-sync-loop] — 2-batch ppl measurement; the per-batch sync IS the measurement boundary
            tot += float(M.loss_fn(params, cfg, next(data))[0])
    return float(np.exp(tot / batches))


def bit_mismatches(a: PyTree, b: PyTree) -> List[str]:
    """Leaf-level bit-parity diff: names + dtypes + raw bytes must agree.

    Container types are allowed to differ (``restore_tree`` rebuilds lists
    where the model may use tuples); the flattened path names are the
    identity.  Leaves may be torch tensors or numpy arrays: each is read as
    a checkpoint stores it (``_to_host``: bf16 as its 16-bit pattern under
    its logical dtype name).
    """
    from repro_torch.checkpoint.manager import _flatten_with_paths, _to_host

    fa, fb = _flatten_with_paths(a), _flatten_with_paths(b)
    bad: List[str] = []
    names_a = [n for n, _ in fa]
    names_b = [n for n, _ in fb]
    if names_a != names_b:
        only_a = set(names_a) - set(names_b)
        only_b = set(names_b) - set(names_a)
        bad.append(f"leaf-name sets differ: -{sorted(only_a)[:3]} "
                   f"+{sorted(only_b)[:3]}")
        return bad
    for (name, la), (_, lb) in zip(fa, fb):
        (xa, da), (xb, db) = _to_host(la), _to_host(lb)
        if da != db:
            bad.append(f"{name}: dtype {da} != {db}")
        elif xa.shape != xb.shape:
            bad.append(f"{name}: shape {xa.shape} != {xb.shape}")
        elif xa.tobytes() != xb.tobytes():
            bad.append(f"{name}: bytes differ")
    return bad


def _sync(dev: torch.device) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def roundtrip(arch: str, workdir: str, *,
              steps: int = SMOKE_DECODE_STEPS, device=None
              ) -> Tuple[Dict[str, Any], Dict[str, Any]]:
    """Full conformance roundtrip for one arch on ``device``; returns
    ``(matrix_row, compression_report)``.

    compress → ppl(dense, compressed) → checkpoint twice (padded banks at
    step 0, re-sliced banks at step 1) → restore each through
    ``Server.from_checkpoint`` → decode all three servers on identical
    prompts → record parity + throughput.  ``tokens_per_s`` times a second
    ``generate`` of the padded checkpoint's server, the device
    synchronized before and after it.
    """
    from repro_torch.checkpoint.manager import CheckpointManager
    from repro_torch.launch.serve import Server, _prefill_extra_len

    dev = resolve_device(device)
    t0 = time.monotonic()
    cfg, dense, comp, report = compress_smoke(arch, device=dev)
    _sync(dev)
    compress_wall = time.monotonic() - t0

    ppl_dense = smoke_ppl(dense, cfg, device=dev)
    ppl_comp = smoke_ppl(comp, cfg, device=dev)

    mgr = CheckpointManager(workdir, async_save=False)
    meta = {"arch": arch, "compress": dict(SMOKE_COMPRESS)}
    mgr.save(0, comp, blocking=True, meta=meta)
    mgr.save(1, comp, blocking=True, meta=meta, reslice_banks=True)

    bank_leaves = sum("rank_per_expert" in e
                      for e in mgr.manifest(0)["leaves"])

    _, padded, meta0 = mgr.restore_tree(0, device=dev)
    _, resliced, _ = mgr.restore_tree(1, device=dev)
    pad_bad = bit_mismatches(comp, padded)
    res_bad = bit_mismatches(comp, resliced)

    prompts, extras = smoke_inputs(cfg, device=dev)
    max_len = (SMOKE_PROMPTS["prompt_len"] + _prefill_extra_len(cfg)
               + steps + 8)
    b = SMOKE_PROMPTS["batch"]

    def decode(server):
        return server.generate(prompts, steps=steps, extras=extras).cpu()

    srv_mem = Server(cfg, comp, max_len=max_len, batch=b, device=dev)
    out_mem = decode(srv_mem)
    srv_pad = Server.from_checkpoint(cfg, workdir, step=0, max_len=max_len,
                                     batch=b, device=dev)
    out_pad = decode(srv_pad)
    srv_res = Server.from_checkpoint(cfg, workdir, step=1, max_len=max_len,
                                     batch=b, device=dev)
    out_res = decode(srv_res)

    _sync(dev)
    t1 = time.monotonic()  # the restored server's decode wall, warmed up
    out2 = decode(srv_pad)
    _sync(dev)
    decode_wall = time.monotonic() - t1

    record = {
        "arch": arch,
        "family": cfg.family,
        "frontend": cfg.frontend,
        "attention": cfg.attention,
        "units": len(report["units"]),
        "bank_leaves": bank_leaves,
        "bit_parity": not pad_bad,
        "resliced_parity": not res_bad,
        "token_match": bool(torch.equal(out_mem, out_pad)
                            and torch.equal(out_mem, out_res)
                            and torch.equal(out_pad, out2)),
        "mismatches": (pad_bad + res_bad)[:8],
        "checkpoint_meta_ok": meta0.get("arch") == arch,
        "ppl_dense": ppl_dense,
        "ppl_compressed": ppl_comp,
        "ppl_ratio": ppl_comp / ppl_dense,
        "tokens_per_s": b * steps / max(decode_wall, 1e-9),
        "compress_wall_s": compress_wall,
        "total_wall_s": time.monotonic() - t0,
    }
    return record, report


# ---------------------------------------------------------------- envelopes
def load_envelopes(path: str) -> Dict[str, Dict[str, float]]:
    with open(path) as f:
        return json.load(f)


def check_envelope(record: Dict[str, Any],
                   env: Optional[Dict[str, float]]) -> List[str]:
    """Violations of one arch's envelope (empty list = inside)."""
    if env is None:
        return [f"{record['arch']}: no envelope checked in"]
    bad: List[str] = []
    if not record["bit_parity"]:
        bad.append(f"bit parity broken: {record['mismatches']}")
    if not record["resliced_parity"]:
        bad.append(f"re-sliced parity broken: {record['mismatches']}")
    if not record["token_match"]:
        bad.append("reloaded server decode diverged from in-memory")
    if record["ppl_ratio"] > env["max_ppl_ratio"]:
        bad.append(f"ppl_ratio {record['ppl_ratio']:.3f} > envelope "
                   f"{env['max_ppl_ratio']}")
    if record["tokens_per_s"] < env["min_tokens_per_s"]:
        bad.append(f"tokens_per_s {record['tokens_per_s']:.1f} < envelope "
                   f"{env['min_tokens_per_s']}")
    return bad
