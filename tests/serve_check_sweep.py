"""Phase 9 (c)'s bf16 chunked-against-whole check on phase 7's model, over
calibration seeds and attention backwards for refinement (ROADMAP hazard 3n).

``chip_smoke.py``'s phase 9 (c) compares chunked prefill (a last chunk of 8
rows: absorbed attention over the latent cache) with whole prefill
(expanded attention) on phase 7's drop-free deepseek-v2-lite, the final
token's logits in bf16 within 5e-2.  This script compresses that model
(``chip_smoke.phase_moe``) for each calibration seed (phase 7's is 1) under
each variant of refinement:

* ``kernel``: refinement's attention gradients from the backward kernel
  (``csrc/flash_attention_bwd.cu``), as the port runs;
* ``plain``: from the plain backward (``ref.flash_attention_bwd_ref``), the
  gradient the port took before the kernel;
* ``off``: no refinement step (``refine_epochs`` 0: the solves alone),

then replays the check's comparisons (last chunks of 256 and of 8, bf16 and
fp32) and prints, beside each value, whether the MoE layer chose the same
experts for the final token in both routes, the gap of its router inputs,
and the router's top-k margin (the k-th probability less the next).  One
JSON line a (seed, variant), then a summary of the bf16 values against the
limit.  On the card only::

    python tests/serve_check_sweep.py [--seeds 1,2,3] [--variants kernel,plain,off]
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path[:0] = [ROOT, os.path.join(ROOT, "src")]

VARIANTS = ("kernel", "plain", "off")
LIMIT = 5e-2  # phase 9 (c)'s bf16 limit

# the final row of each MoE call while _ON[0]: router input, output, the
# experts chosen and the router's top-k margin
_REC, _ON = [], [False]


def _record_router(torch):
    """Wrap ``mlp.moe_apply`` to fill ``_REC`` while ``_ON[0]``."""
    from repro_torch.models import layers as L
    from repro_torch.models import mlp

    moe_apply = mlp.moe_apply

    def wrapped(p, x, cfg, **kw):
        y = moe_apply(p, x, cfg, **kw)
        if _ON[0]:
            xt = x.reshape(-1, x.shape[-1])[-1:]
            probs = torch.softmax(L.linear(p["router"], xt.float(),
                                           dtype=torch.float32), -1)
            top, ids = torch.topk(probs, cfg.moe.top_k + 1, dim=-1)
            _REC.append({"x": xt.float().cpu(),
                         "y": y[0].reshape(-1, y[0].shape[-1])[-1:].float()
                         .cpu(),
                         "ids": sorted(ids[0, :cfg.moe.top_k].tolist()),
                         "margin": float(top[0, -2] - top[0, -1])})
        return y

    mlp.moe_apply = wrapped


def replay(cs, torch, np, cfg, comp):
    """Phase 9 (c)'s chunked-against-whole comparisons on ``comp``, with
    the final token's routing in both routes.  Its sequence is the one
    phase 9 draws after its (a) and (b) requests."""
    from repro_torch.launch import serve as TS
    from repro_torch.models import model as M

    sizes = cs.SIZES
    rng = np.random.default_rng(17)
    b, plen, _, _ = sizes["serve_dense"]
    rng.integers(0, cfg.vocab_size, (b, plen), dtype=np.int32)
    slots, max_len, chunk, n_req, (lo, hi), _ = sizes["serve_engine"]
    for n in rng.integers(lo, hi + 1, n_req):
        rng.integers(0, cfg.vocab_size, (n,), dtype=np.int32)
    params = TS.ContinuousBatchingServer(cfg, comp, max_len=max_len,
                                         slots=slots, prefill_chunk=chunk,
                                         device="cuda").params
    plen, n_dec, max_len = sizes["serve_check"]
    seq = torch.from_numpy(rng.integers(0, cfg.vocab_size, (1, plen + n_dec),
                                        dtype=np.int32)).cuda()
    out = {}
    with torch.inference_mode():
        for name, c in (("bf16", cfg), ("fp32", cfg.replace(dtype="float32"))):
            for tail in (0, 8):
                end = plen + tail
                _REC.clear()
                _ON[0] = True
                cache = M.init_cache(c, 1, max_len, device="cuda")
                for c0 in range(0, end, chunk):
                    last, cache = M.prefill(
                        params, c, {"tokens": seq[:, c0:min(end, c0 + chunk)]},
                        cache, pos=c0, chunked=True)
                rc = _REC[-1]
                _REC.clear()
                whole = M.prefill(params, c, {"tokens": seq[:, :end]},
                                  M.init_cache(c, 1, max_len,
                                               device="cuda"))[0]
                rw = _REC[-1]
                _ON[0] = False
                out[f"{name}_last_chunk_{chunk if tail == 0 else tail}"] = {
                    "logits": cs.rel_fro(last, whole),
                    "same_experts": rc["ids"] == rw["ids"],
                    "router_in": float((rc["x"] - rw["x"]).norm()
                                       / rw["x"].norm()),
                    "moe_out": float((rc["y"] - rw["y"]).norm()
                                     / rw["y"].norm()),
                    "margin": [rc["margin"], rw["margin"]]}
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--seeds", default="1,2,3",
                    help="calibration seeds, comma-separated (phase 7: 1)")
    ap.add_argument("--variants", default=",".join(VARIANTS))
    args = ap.parse_args(argv)
    import numpy as np
    import torch
    if not torch.cuda.is_available():
        print("serve_check_sweep: no CUDA device", file=sys.stderr)
        return 2
    import chip_smoke as cs
    from repro_torch.kernels import build, ops, ref

    cs.OUT.mkdir(exist_ok=True)
    cs.LOG = cs.OUT / "serve_check_sweep.log"
    cs.LOG.write_text("")
    cs.require = lambda cond, msg: cond  # the phase's own checks: logged
    build.library()
    _record_router(torch)
    kernel = ops._flash_attention_bwd_kernel

    def plain(q, k, v, out, lse, dout, q_offset, causal, window, softcap,
              needs):
        ops.LAUNCHES["flash_attention_bwd"] += 1
        return ref.flash_attention_bwd_ref(
            q, k, v, dout, needs=needs, causal=causal, window=window,
            q_offset=q_offset, softcap=softcap)

    summary = {}
    for seed in (int(x) for x in args.seeds.split(",")):
        for variant in args.variants.split(","):
            ops._flash_attention_bwd_kernel = plain if variant == "plain" \
                else kernel
            t0 = time.perf_counter()
            try:
                run, cfg, comp = cs.phase_moe(
                    torch, ops, calib_seed=seed,
                    refine_epochs=0 if variant == "off" else 1)
            finally:
                ops._flash_attention_bwd_kernel = kernel
            out = replay(cs, torch, np, cfg, comp)
            print(variant, json.dumps({"seed": seed,
                                       "ce": run.get("compressed"), **out,
                                       "s": time.perf_counter() - t0}),
                  flush=True)
            summary.setdefault(variant, []).append(
                [seed] + [round(out[k]["logits"], 5) for k in
                          ("bf16_last_chunk_256", "bf16_last_chunk_8")])
            del run, comp
            torch.cuda.empty_cache()
    print("summary (seed, bf16 last chunk 256, last chunk 8; limit "
          f"{LIMIT}):", json.dumps(summary), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
