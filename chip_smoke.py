#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port of AA-SVD (``src/repro_torch``) on one GPU.

    python3 chip_smoke.py            # from the repository root, one CUDA card
    python3 chip_smoke.py --only lowrank   # phases 1-2 and lowrank_matmul

Phases, each fatal on failure (non-zero exit, no result line):

1. device  — needs CUDA; prints the card's name and power limit.
2. build   — compiles the hand-written kernels (``src/repro_torch/csrc``);
             prints nvcc's version and whether the wgmma body's SASS holds
             HGMMA (``cuobjdump``, where the toolkit has it).
3. kernels — every kernel against its plain PyTorch version on the card, at
             the main paths' shapes and ragged ones, in fp32 and bf16, with
             times (CUDA events, median of 10 runs after warm-up), the plain
             version's time, one PyTorch yardstick (``library_ms``) where a
             single call computes the same function, and the card's least
             time for the same work (``bound_ms``); ``grouped_matmul`` also
             backward (dx, dW) against autograd through its plain version at
             a refinement shape and the ragged one, and ``flash_attention``
             at MLA prefill's head dim 192.  ``lowrank_matmul`` at T 4096,
             256 and 8 for each llama shape, ragged T through every body,
             and T 1-64 with each bf16 body forced; beside its ``ms`` (one
             call between CUDA events, as every kernel is timed) it gives
             ``device_ms``: the device time of one call in a run of launches
             replayed from a CUDA graph, the L2 evicted before each (no host
             time, no launch start-up), and the same for the yardstick
             (``library_device_ms``); and x @ V alone (``lowrank_down``,
             the latent cache's projections) under each body.  ``--only
             lowrank`` runs phases 1-2 and these rows alone.
4. smoke   — the smoke compression recipe on the card (kernels) and on the
             CPU (plain versions) from the same params and tokens; then the
             compressed smoke model served on both (continuous batching over
             the latent cache, and the fixed-batch server): tokens equal,
             logits held to a stated tolerance.  Then deepseek-v2-lite's
             smoke config compressed with drop-free MoE dispatch on both:
             routed expert ids equal, composed maps (per expert) and loss
             held to stated tolerances.
5. main    — Algorithm 2 on llama-7b at its published widths, depth cut to
             2 layers, random weights from a seeded ``torch.Generator``:
             calibration 8 × 1024 tokens, ratio 0.6, fused calibration, one
             refine epoch; then the dense and compressed eval losses.  The
             kernels' launch counts are zeroed just before and read just
             after; cov_accum, lowrank_matmul and flash_attention must be
             > 0.
6. serve   — phase 5's models served at llama-7b widths under
             ``torch.inference_mode()``: (a) ``Server`` on the dense params,
             batch 8, 512-token prompts, 32 steps; (b)
             ``ContinuousBatchingServer`` on the compressed params, 8 slots,
             max_len 2048, 256-token prefill chunks, 12 requests of 128-1024
             tokens and 64 steps through the latent cache.  Counts are
             zeroed before each and read after: flash_attention > 0 in both,
             flash_decode and lowrank_matmul > 0 in (b).  Then latent-cache
             decode against dense-cache decode, and chunked against whole
             prefill (a last chunk of 256 rows and one of 8), on one
             teacher-forced sequence.  Prints time to first
             token, prefill and decode tokens/s, the median decode step,
             cache bytes (latent / dense) and peak device memory.
7. moe     — Algorithm 2 on deepseek-v2-lite-16b at its published widths
             (MLA attention, 64 routed experts top-6 + 2 shared, drop-free
             dispatch), depth cut to 2 layers (one ``mla_dense_first``, one
             ``mla_moe``), random weights from a seeded ``torch.Generator``:
             calibration 8 × 1024 tokens, ratio 0.6, fused calibration, one
             refine epoch; then the dense and compressed eval losses.  Counts
             zeroed just before and read just after: grouped_matmul,
             cov_accum, lowrank_matmul and flash_attention must be > 0.

It prints a ``{"kernels": [...]}`` line, then
``{"ok": true, "device": {...}}`` as the last line.  Long output goes to
``chiprun_out/chip_smoke.log``.
"""

from __future__ import annotations

import json
import math
import pathlib
import statistics
import subprocess
import sys
import time

ROOT = pathlib.Path(__file__).resolve().parent
SRC = ROOT / "src"
OUT = ROOT / "chiprun_out"
LOG = OUT / "chip_smoke.log"

# H100 SXM peaks (NVIDIA data sheet, dense): bytes/s and flop/s by input type
HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {"float32": 67e12, "bfloat16": 989e12}

# the main path's shapes: T = microbatch 4 x 1024 tokens; (n, k, m) of
# llama-7b's linears at ratio 0.6 (rank multiple 8), plus ragged ones
SIZES = {
    "tokens": 4096,
    "cov_n": (4096, 11008, 80),
    "lowrank_nkm": ((4096, 1232, 4096), (4096, 1792, 11008),
                    (11008, 1792, 4096), (64, 19, 160)),
    # lowrank_matmul rows per llama shape: T 4096 (compression, eval, whole
    # prefill), 256 (the engine's prefill chunk), 8 (decode of 8 slots);
    # ragged T through both bodies; each bf16 body forced at small T
    "lowrank_T": (4096, 256, 8),
    "lowrank_ragged_T": (1, 3, 77, 129),
    "lowrank_forced_T": (1, 3, 8, 16, 32, 64),
    "layers": 2,
    "calib": (8, 1024),
    "microbatch": 4,
    "evals": (2, 4, 1024),
    # flash_attention: (name, B, H, KV, Lq, Lk, D, causal, window, softcap,
    # q_offset: an int or (lo, hi) spread over the B slots); the first three
    # are serving's shapes at llama-7b (whole prefill, a 256-token chunk or
    # latent prefill against a 2048 cache, dense decode of 8 slots), the
    # fourth deepseek-v2-lite's MLA prefill in phase 7 (microbatch 4, 16
    # heads, head dim qk_nope 128 + qk_rope 64); all but "ragged" are timed
    "flash_attention": (
        ("prefill", 1, 32, 32, 1024, 1024, 128, True, 0, 0.0, 0),
        ("chunk", 1, 32, 32, 256, 2048, 128, True, 0, 0.0, 768),
        ("decode", 8, 32, 32, 1, 2048, 128, True, 0, 0.0, (100, 2047)),
        ("mla_prefill", 4, 16, 16, 1024, 1024, 192, True, 0, 0.0, 0),
        ("ragged", 2, 4, 2, 77, 77, 16, True, 16, 30.0, 0)),
    # grouped_matmul: (name, M, d, f, E) — phase 7's expert GEMMs, M = 4 x
    # 1024 tokens x top-6 routed rows over 64 experts: the dense bank's
    # gate/up and down, the factorized banks' x @ V and t @ U at rank 504;
    # then a ragged case (f not a multiple of 8, M not of the row tile).
    # Group sizes: a skewed numpy draw with two experts empty
    "grouped": (
        ("gate_up", 24576, 2048, 1408, 64),
        ("down", 24576, 1408, 2048, 64),
        ("gate_up_v", 24576, 2048, 504, 64),
        ("gate_up_u", 24576, 504, 1408, 64),
        ("down_v", 24576, 1408, 504, 64),
        ("down_u", 24576, 504, 2048, 64),
        ("ragged", 4133, 200, 77, 9)),
    # phase 7: deepseek-v2-lite at published widths, depth cut 27 -> 2
    "moe_layers": 2,
    # flash_decode: (name, B, H, KV, D, r_k, r_v, L, lengths (lo, hi));
    # llama-7b at ratio 0.6 (rank 1232, PERF.md row 2), then a ragged one
    "flash_decode": (
        ("llama", 8, 32, 32, 128, 1232, 1232, 2048, (256, 2048)),
        ("ragged", 3, 4, 2, 16, 19, 24, 77, (1, 77))),
    # serving: Server (batch, prompt, steps, max_len) on the dense model;
    # the engine (slots, max_len, chunk, requests, prompt lo/hi, steps) on
    # the compressed one; the teacher-forced checks (prompt, steps, max_len)
    "serve_dense": (8, 512, 32, 1024),
    "serve_engine": (8, 2048, 256, 12, (128, 1024), 64),
    "serve_check": (512, 16, 1024),
}


class PhaseError(RuntimeError):
    pass


def log(*args):
    line = " ".join(str(a) for a in args)
    print(line, flush=True)
    with open(LOG, "a") as f:
        f.write(line + "\n")


def require(cond, msg):
    if not cond:
        raise PhaseError(msg)


# ---------------------------------------------------------------------------
# timing


def time_ms(fn, *, warmup=3, reps=10):
    """Median device milliseconds of ``fn()`` over ``reps`` runs (CUDA
    events around each run, after ``warmup`` runs)."""
    import torch
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


FLUSH_BYTES = 256 << 20   # a read this large evicts the H100's 50 MB L2


def device_ms(fn, *, calls=10, reps=5):
    """Device milliseconds of one ``fn()`` in a run of ``calls`` launches:
    CUDA events around a replay of a CUDA graph holding the run (so no host
    time is counted), over ``calls``, median of ``reps`` replays after 3
    eager warm-up runs.  A 256 MB read precedes each call in the graph,
    evicting the L2 as a decode step finds each linear's factors (read once
    a step); a graph of the reads alone is timed the same way and taken
    off.  The cuBLAS workspaces that capture leaves behind are freed after,
    so later phases' peak memory does not carry them."""
    import torch
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    flush = torch.ones(FLUSH_BYTES // 4, device="cuda")

    def run(with_fn):
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            for _ in range(calls):
                flush.sum()     # a read: leaves the L2 clean, no write-back
                if with_fn:
                    fn()
        times = []
        for _ in range(reps + 1):
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            graph.replay()
            end.record()
            end.synchronize()
            times.append(start.elapsed_time(end))
        del graph
        return statistics.median(times[1:])

    ms = (run(True) - run(False)) / calls
    torch.cuda.synchronize()
    torch._C._cuda_clearCublasWorkspaces()
    return ms


def lowrank_rows(ops):
    """lowrank_matmul's launches since the last reset, by row count T and
    split at 16 (the small-T body's bf16 limit) and 64."""
    rows = dict(sorted(ops.LOWRANK_ROWS.items()))
    return {"by_rows": rows,
            "rows<=16": sum(c for t, c in rows.items() if t <= 16),
            "rows<=64": sum(c for t, c in rows.items() if t <= 64),
            "rows>64": sum(c for t, c in rows.items() if t > 64)}


def bound(flops, nbytes, dtype_name):
    t_ops = flops / PEAK_FLOPS[dtype_name]
    t_bytes = nbytes / HBM_BYTES_PER_S
    return (max(t_ops, t_bytes) * 1e3,
            "operations" if t_ops >= t_bytes else "bytes")


def rel_fro(a, b):
    return float((a.float() - b.float()).norm() / b.float().norm())


# ---------------------------------------------------------------------------
# phase 3: kernels against their plain versions


def check_cov(torch, ops, ref, t_rows, n, dtype, with_acc, timed, dev):
    gen = torch.Generator(device=dev).manual_seed(n + t_rows)
    x = torch.randn(t_rows, n, generator=gen, device=dev).to(dtype)
    xp = (x.float() + 0.1 * torch.randn(t_rows, n, generator=gen,
                                        device=dev)).to(dtype)
    want = ref.cov_accum_ref(x, xp)
    acc0 = None
    if with_acc:
        acc0 = tuple(torch.randn(n, n, generator=gen, device=dev)
                     for _ in range(3))
        want = tuple(a + w for a, w in zip(acc0, want))
        got = ops.cov_accum(x, xp, acc=tuple(a.clone() for a in acc0))
    else:
        got = ops.cov_accum(x, xp)
    err = max(rel_fro(g, w) for g, w in zip(got, want))
    mae = max(float((g - w).abs().max()) for g, w in zip(got, want))
    # fp32 inputs (FMA units): fp32 sums of T products in another order, and
    # with atomics in a run-dependent order when T is split: 1e-5 relative
    # Frobenius.  bf16 inputs (tensor cores): the products are exact, but the
    # tensor cores' fp32 accumulation keeps fewer bits than an FMA chain
    # (9.1e-6 at T 4096 on an H100): 5e-5
    lim = 1e-5 if dtype == torch.float32 else 5e-5
    require(err <= lim, f"cov_accum T={t_rows} n={n} {dtype} acc={with_acc}"
            f": rel err {err:.3e} > {lim:.0e}")
    row = {"shape": [t_rows, n], "dtype": str(dtype).replace("torch.", ""),
           "acc": with_acc, "rel_fro_err": err, "max_abs_err": mae}
    if timed:
        accs = tuple(torch.zeros(n, n, device=dev) for _ in range(3))
        row["ms"] = time_ms(lambda: ops.cov_accum(
            x, xp, acc=accs if with_acc else None))
        row["plain_ms"] = time_ms(lambda: ref.cov_accum_ref(x, xp))
        # yardstick: the three products as cuBLAS matmuls in the input type
        row["library_ms"] = time_ms(lambda: (torch.matmul(x.T, x),
                                             torch.matmul(x.T, xp),
                                             torch.matmul(xp.T, xp)))
        eb = x.element_size()
        # xxp, plus the distinct halves of the symmetric xx and xpxp
        flops = 2 * t_rows * n * n + 2 * t_rows * n * (n + 1)
        nbytes = 2 * t_rows * n * eb + 3 * n * n * 4 * (2 if with_acc else 1)
        row["bound_ms"], row["bound_by"] = bound(flops, nbytes,
                                                 row["dtype"])
    return row


def check_lowrank(torch, ops, ref, t_rows, n, k, m, dtype, epilogue, timed,
                  dev, body=None):
    """One lowrank_matmul case against its plain version; ``body`` forces
    a body of the launch plan, None lets the plan choose."""
    from repro_torch.kernels import lowrank_matmul as low
    gen = torch.Generator(device=dev).manual_seed(n + k + m)
    x = torch.randn(t_rows, n, generator=gen, device=dev).to(dtype)
    v = (torch.randn(n, k, generator=gen, device=dev) / math.sqrt(n)
         ).to(dtype)
    u = (torch.randn(k, m, generator=gen, device=dev) / math.sqrt(k)
         ).to(dtype)
    bias = res = None
    if epilogue:
        bias = torch.randn(m, generator=gen, device=dev).to(dtype)
        res = torch.randn(t_rows, m, generator=gen, device=dev).to(dtype)
    want = ref.lowrank_matmul_ref(x, v, u)
    if epilogue:
        want = want + bias + res

    def run():
        if body is None:
            return ops.lowrank_matmul(x, v, u, bias=bias, residual=res)
        return ops._lowrank_kernel(x, v, u, bias, res, body=body)[0]

    got = run()
    mae = float((got.float() - want.float()).abs().max())
    if dtype == torch.float32:
        err = rel_fro(got, want)
        require(err <= 1e-5, f"lowrank_matmul {t_rows}x{n}x{k}x{m} fp32 "
                f"epilogue={epilogue}: rel err {err:.3e} > 1e-5")
    else:
        # t rounds to bf16 in both; the epilogue adds run in fp32 in the
        # kernel and after the bf16 cast in the plain version
        lim = 2e-2 * float(want.float().abs().max())
        err = mae
        require(mae <= lim, f"lowrank_matmul {t_rows}x{n}x{k}x{m} bf16 "
                f"epilogue={epilogue}: max abs err {mae:.3e} > {lim:.3e}")
    p = low.plan(t_rows, n, k, m, dtype, body=body)
    row = {"shape": [t_rows, n, k, m], "dtype": str(dtype)
           .replace("torch.", ""), "epilogue": epilogue, "err": err,
           "max_abs_err": mae, "body": p.body, "forced": body is not None,
           "grid_xv": p.grid("xv"), "grid_tu": p.grid("tu"),
           "tile_rows": [p.tile_rows_xv, p.tile_rows_tu]}
    if timed:
        # ms: one call between CUDA events, as every kernel here is timed
        # (host launch work included); device_ms: the device time alone
        library = lambda: torch.matmul(torch.matmul(x, v), u)  # noqa: E731
        row["ms"] = time_ms(run)
        row["device_ms"] = device_ms(run)
        row["plain_ms"] = time_ms(lambda: ref.lowrank_matmul_ref(x, v, u))
        row["library_ms"] = time_ms(library)
        row["library_device_ms"] = device_ms(library)
        eb = x.element_size()
        flops = 2 * t_rows * k * (n + m)
        nbytes = (t_rows * n + n * k + k * m + t_rows * m) * eb
        if epilogue:
            nbytes += (m + t_rows * m) * eb
        row["bound_ms"], row["bound_by"] = bound(flops, nbytes,
                                                 row["dtype"])
    return row


def check_lowrank_down(torch, ops, t_rows, n, k, dtype, invariant, dev):
    """``ops.lowrank_down`` (x @ V alone, the serving latents) against the
    plain product rounded once, under the plan's body or, with
    ``invariant``, under ``ops.batch_invariant`` (prefill's); the limits of
    check_lowrank."""
    import contextlib
    gen = torch.Generator(device=dev).manual_seed(n + k + t_rows)
    x = torch.randn(t_rows, n, generator=gen, device=dev).to(dtype)
    v = (torch.randn(n, k, generator=gen, device=dev) / math.sqrt(n)
         ).to(dtype)
    want = torch.matmul(x.float(), v.float()).to(dtype)
    with ops.batch_invariant() if invariant else contextlib.nullcontext():
        got = ops.lowrank_down(x, v)
    mae = float((got.float() - want.float()).abs().max())
    if dtype == torch.float32:
        err = rel_fro(got, want)
        require(err <= 1e-5, f"lowrank_down {t_rows}x{n}x{k} fp32 "
                f"invariant={invariant}: rel err {err:.3e} > 1e-5")
    else:
        err = mae
        lim = 2e-2 * float(want.float().abs().max())
        require(mae <= lim, f"lowrank_down {t_rows}x{n}x{k} bf16 "
                f"invariant={invariant}: max abs err {mae:.3e} > {lim:.3e}")
    return {"shape": [t_rows, n, k], "dtype": str(dtype).replace(
        "torch.", ""), "batch_invariant": invariant, "err": err,
        "max_abs_err": mae}


def phase_kernels(torch, ops, ref, dev="cuda", sizes=SIZES):
    cov_rows, low_rows = [], []
    t_rows = sizes["tokens"]
    for i, n in enumerate(sizes["cov_n"]):
        for dtype in (torch.float32, torch.bfloat16):
            for with_acc in (False, True):
                # timed at the main path's calls (bf16 activations, acc=);
                # the last shape is the ragged one
                timed = (i < len(sizes["cov_n"]) - 1
                         and dtype == torch.bfloat16 and with_acc)
                row = check_cov(torch, ops, ref, t_rows, n, dtype, with_acc,
                                timed, dev)
                cov_rows.append(row)
                log("cov_accum", json.dumps(row))
    return cov_rows, phase_lowrank(torch, ops, ref, dev, sizes)


def phase_lowrank(torch, ops, ref, dev="cuda", sizes=SIZES):
    """lowrank_matmul at each llama shape and T of ``lowrank_T`` (fp32 and
    bf16, with and without the epilogue; timed in bf16 without it), ragged
    T at the first llama shape and at the ragged (n, k, m), then each bf16
    body forced at the T of ``lowrank_forced_T`` it takes (two llama shapes
    and the ragged one: prefill takes the wgmma body at any T)."""
    from repro_torch.kernels import lowrank_matmul as low
    rows = []

    def add(*args, **kw):
        row = check_lowrank(torch, ops, ref, *args, dev=dev, **kw)
        rows.append(row)
        log("lowrank_matmul", json.dumps(row))

    shapes = sizes["lowrank_nkm"]
    dtypes = (torch.float32, torch.bfloat16)
    for n, k, m in shapes[:-1]:
        for t_rows in sizes["lowrank_T"]:
            for dtype in dtypes:
                for epilogue in (False, True):
                    add(t_rows, n, k, m, dtype, epilogue,
                        dtype == torch.bfloat16 and not epilogue)
    n, k, m = shapes[0]
    for t_rows in sizes["lowrank_ragged_T"]:
        for dtype in dtypes:
            add(t_rows, n, k, m, dtype, True, False)
    n, k, m = shapes[-1]
    for t_rows in sizes["lowrank_ragged_T"] + (sizes["tokens"],):
        for dtype in dtypes:
            for epilogue in (False, True):
                add(t_rows, n, k, m, dtype, epilogue, False)
    small_max = low.SMALL_ROWS[torch.bfloat16][-1]
    for n, k, m in shapes[:2] + shapes[-1:]:
        for t_rows in sizes["lowrank_forced_T"]:
            for body in ("small_t", "wgmma"):
                if body == "wgmma" or t_rows <= small_max:
                    add(t_rows, n, k, m, torch.bfloat16, False, False,
                        body=body)
    # x @ V alone (the latent cache's projections), at the attention
    # shape's and the ragged shape's (n, k)
    for n, k, _ in shapes[:1] + shapes[-1:]:
        for t_rows in sizes["lowrank_ragged_T"] + (8, 256):
            for dtype in dtypes:
                for invariant in (False, True):
                    row = check_lowrank_down(torch, ops, t_rows, n, k, dtype,
                                             invariant, dev)
                    rows.append(row)
                    log("lowrank_down", json.dumps(row))
    return rows


def sass_report(lib_path):
    """{kernel symbol: HGMMA instruction count} from ``cuobjdump
    --dump-sass`` of the built library, or None without cuobjdump."""
    import shutil
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    if not pathlib.Path(tool).exists():
        return None
    out = subprocess.run([tool, "--dump-sass", str(lib_path)],
                         capture_output=True, text=True, timeout=300)
    require(out.returncode == 0, f"cuobjdump failed: {out.stderr[-2000:]}")
    counts, fn = {}, None
    for line in out.stdout.splitlines():
        if "Function :" in line:
            fn = line.split("Function :", 1)[1].strip()
            counts[fn] = 0
        elif fn is not None and "HGMMA" in line:
            counts[fn] += 1
    return counts


def _spread(np, spec, n):
    """``n`` integers spread evenly over (lo, hi), or ``spec`` n times."""
    if isinstance(spec, tuple):
        return np.linspace(spec[0], spec[1], n).astype(np.int64).tolist()
    return [spec] * n


def _live_keys(q_pos, lk, causal, window):
    """(live key count, first key, last key) of one query row."""
    hi = min(q_pos, lk - 1) if causal else lk - 1
    lo = max(0, q_pos - window + 1) if window else 0
    return max(0, hi - lo + 1), lo, hi


def check_flash_attention(torch, np, ops, ref, case, dtype, timed, dev):
    name, b, h, kv, lq, lk, d, causal, window, softcap, off = case
    gen = torch.Generator(device=dev).manual_seed(lq + lk + d)
    q = torch.randn(b, lq, h, d, generator=gen, device=dev).to(dtype)
    k = torch.randn(b, lk, kv, d, generator=gen, device=dev).to(dtype)
    v = torch.randn(b, lk, kv, d, generator=gen, device=dev).to(dtype)
    offs = _spread(np, off, b)
    q_offset = (torch.tensor(offs, dtype=torch.int32, device=dev)
                if isinstance(off, tuple) else off)
    kw = dict(causal=causal, window=window, q_offset=q_offset,
              softcap=softcap)
    want = ref.flash_attention_ref(q, k, v, **kw)
    got = ops.flash_attention(q, k, v, **kw)
    err = rel_fro(got, want)
    mae = float((got.float() - want.float()).abs().max())
    # fp32: the same fp32 arithmetic in another order (and the card's own
    # exp / tanh): 1e-5 relative Frobenius.  bf16: the output rounds to
    # bf16 (2^-8 relative) and p rounds to bf16 before PV in both, where a
    # score an ulp apart can round p the other way: 1e-2
    lim = 1e-5 if dtype == torch.float32 else 1e-2
    require(err <= lim, f"flash_attention {name} {dtype}: rel err "
            f"{err:.3e} > {lim:.0e}")
    row = {"case": name, "shape": [b, h, kv, lq, lk, d],
           "dtype": str(dtype).replace("torch.", ""), "causal": causal,
           "window": window, "softcap": softcap, "q_offset": offs,
           "rel_fro_err": err, "max_abs_err": mae}
    if timed:
        row["ms"] = time_ms(lambda: ops.flash_attention(q, k, v, **kw))
        row["plain_ms"] = time_ms(lambda: ref.flash_attention_ref(q, k, v,
                                                                  **kw))
        # yardstick: scaled_dot_product_attention on the same inputs in its
        # (B, H, L, D) layout, the masks as a boolean mask (never called by
        # the port; it has no soft cap)
        qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
        qpos = (torch.tensor(offs, device=dev)[:, None, None, None]
                + torch.arange(lq, device=dev)[:, None])
        kpos = torch.arange(lk, device=dev)
        mask = torch.ones_like(qpos + kpos, dtype=torch.bool)
        if causal:
            mask &= kpos <= qpos
        if window:
            mask &= kpos > qpos - window
        sdpa = torch.nn.functional.scaled_dot_product_attention
        row["library_ms"] = (None if softcap or kv != h else time_ms(
            lambda: sdpa(qt, kt, vt, attn_mask=mask)))
        eb = q.element_size()
        live = keys = 0
        for o in offs:
            spans = [_live_keys(o + i, lk, causal, window) for i in range(lq)]
            live += sum(sp[0] for sp in spans)
            keys += (max(sp[2] for sp in spans)
                     - min(sp[1] for sp in spans) + 1)
        flops = 4 * h * d * live
        nbytes = (2 * b * lq * h * d + 2 * keys * kv * d) * eb
        row["bound_ms"], row["bound_by"] = bound(flops, nbytes,
                                                 row["dtype"])
    return row


def check_flash_decode(torch, np, ops, ref, case, dtype, timed, dev):
    from repro_torch.models import layers as L
    name, b, h, kv, d, rk, rv, l, spread = case
    gen = torch.Generator(device=dev).manual_seed(rk + rv + l)
    q = torch.randn(b, h, d, generator=gen, device=dev).to(dtype)
    lk = torch.randn(b, l, rk, generator=gen, device=dev).to(dtype)
    lv = torch.randn(b, l, rv, generator=gen, device=dev).to(dtype)
    uk = torch.randn(rk, kv * d, generator=gen, device=dev) / math.sqrt(rk)
    uv = torch.randn(rv, kv * d, generator=gen, device=dev) / math.sqrt(rv)
    lens = _spread(np, spread, b)
    lengths = torch.tensor(lens, dtype=torch.int32, device=dev)
    cos, sin = L.rope_table(torch.arange(l, device=dev), d, 10000.0)
    args = (q, lk, lv, uk, uv, lengths, cos, sin)
    want = ref.flash_decode_ref(*args)
    got = ops.flash_decode(*args)
    err = rel_fro(got, want)
    mae = float((got.float() - want.float()).abs().max())
    # all arithmetic fp32 in both, summed in another order: 1e-5 relative
    # Frobenius; bf16 queries / latents give a bf16 output (2^-8): 5e-3
    lim = 1e-5 if dtype == torch.float32 else 5e-3
    require(err <= lim, f"flash_decode {name} {dtype}: rel err {err:.3e} "
            f"> {lim:.0e}")
    row = {"case": name, "shape": [b, h, kv, d, rk, rv, l],
           "dtype": str(dtype).replace("torch.", ""), "lengths": lens,
           "rel_fro_err": err, "max_abs_err": mae}
    if timed:
        row["ms"] = time_ms(lambda: ops.flash_decode(*args))
        row["plain_ms"] = time_ms(lambda: ref.flash_decode_ref(*args))
        # no single PyTorch call computes attention with in-kernel key
        # up-projection and latent-space values
        row["library_ms"] = None
        eb = q.element_size()
        live = sum(lens)
        flops = (2 * live * (rk * kv * d + h * d + h * rv)
                 + 2 * b * h * rv * d)
        nbytes = (live * (rk + rv) * eb + (rk + rv) * kv * d * 4
                  + 2 * b * h * d * eb)
        # the function is defined in fp32 arithmetic: the fp32 peak
        row["bound_ms"], row["bound_by"] = bound(flops, nbytes, "float32")
    return row


def phase_attention_kernels(torch, np, ops, ref, dev="cuda", sizes=SIZES):
    fa_rows, fd_rows = [], []
    for case in sizes["flash_attention"]:
        for dtype in (torch.float32, torch.bfloat16):
            timed = case[0] != "ragged" and dtype == torch.bfloat16
            row = check_flash_attention(torch, np, ops, ref, case, dtype,
                                        timed, dev)
            fa_rows.append(row)
            log("flash_attention", json.dumps(row))
    for i, case in enumerate(sizes["flash_decode"]):
        for dtype in (torch.float32, torch.bfloat16):
            timed = i == 0 and dtype == torch.bfloat16
            row = check_flash_decode(torch, np, ops, ref, case, dtype, timed,
                                     dev)
            fd_rows.append(row)
            log("flash_decode", json.dumps(row))
    return fa_rows, fd_rows


def _group_sizes(np, m, e, seed):
    """Skewed sizes summing to m (a Dirichlet(0.3) draw), experts 1 and
    e // 2 empty."""
    rng = np.random.default_rng(seed)
    p = rng.dirichlet(np.full(e, 0.3))
    p[[1, e // 2]] = 0.0
    return rng.multinomial(m, p / p.sum())


def _grouped_mm_library(torch, x, w, gs):
    """``torch._grouped_mm`` on the same inputs (bf16 only, a yardstick the
    port never calls), or None with the reason."""
    fn = getattr(torch, "_grouped_mm", None)
    if fn is None:
        return None, f"torch {torch.__version__} has no torch._grouped_mm"
    if x.dtype != torch.bfloat16:
        return None, "torch._grouped_mm takes bf16 only"
    offs = torch.cumsum(gs, 0, dtype=torch.int32)
    try:
        out = fn(x, w, offs=offs)
        torch.cuda.synchronize()
    except RuntimeError as exc:   # a yardstick only: report why, never fail
        return None, f"torch._grouped_mm refused: {str(exc)[:200]}"
    return (lambda: fn(x, w, offs=offs)), out


def check_grouped(torch, np, ops, ref, case, dtype, timed, dev):
    name, m, d, f, e = case
    sizes = _group_sizes(np, m, e, m + d + f)
    gs = torch.tensor(sizes, dtype=torch.int32, device=dev)
    gen = torch.Generator(device=dev).manual_seed(m + d + f)
    x = torch.randn(m, d, generator=gen, device=dev).to(dtype)
    w = (torch.randn(e, d, f, generator=gen, device=dev) / math.sqrt(d)
         ).to(dtype)
    want = ref.grouped_matmul_ref(x, w, gs)
    got = ops.grouped_matmul(x, w, gs)
    err = rel_fro(got, want)
    mae = float((got.float() - want.float()).abs().max())
    # fp32 (FMA units): the same fp32 products summed in another order:
    # 1e-5.  bf16 (tensor cores): exact products, fp32 accumulation, the
    # output rounded to bf16 (2^-8 relative): 1e-2
    lim = 1e-5 if dtype == torch.float32 else 1e-2
    require(tuple(got.shape) == (m, f) and got.dtype == dtype,
            f"grouped_matmul {name}: {tuple(got.shape)} {got.dtype}")
    require(err <= lim, f"grouped_matmul {name} {dtype}: rel err {err:.3e} "
            f"> {lim:.0e}")
    row = {"case": name, "shape": [m, d, f, e],
           "dtype": str(dtype).replace("torch.", ""),
           "empty_experts": int((sizes == 0).sum()),
           "largest_group": int(sizes.max()), "rel_fro_err": err,
           "max_abs_err": mae}
    if timed:
        row["ms"] = time_ms(lambda: ops.grouped_matmul(x, w, gs))
        row["plain_ms"] = time_ms(lambda: ref.grouped_matmul_ref(x, w, gs))
        lib, out = _grouped_mm_library(torch, x, w, gs)
        row["library_ms"] = None if lib is None else time_ms(lib)
        if lib is None:
            row["library_note"] = out
        else:
            row["library_rel_err"] = rel_fro(out, want)
        eb = x.element_size()
        live = int((sizes > 0).sum())       # experts whose weights are read
        flops = 2 * m * d * f
        nbytes = (m * d + live * d * f + m * f) * eb
        row["bound_ms"], row["bound_by"] = bound(flops, nbytes, row["dtype"])
    return row


def check_grouped_backward(torch, np, ops, ref, case, dtype, dev):
    """dx (the kernel on wᵀ) and dW (per-segment products) against autograd
    through the plain version, on the same inputs and cotangent."""
    name, m, d, f, e = case
    sizes = _group_sizes(np, m, e, m + d + f + 1)
    gs = torch.tensor(sizes, dtype=torch.int32, device=dev)
    gen = torch.Generator(device=dev).manual_seed(m + d + f + 1)
    x0 = torch.randn(m, d, generator=gen, device=dev).to(dtype)
    w0 = (torch.randn(e, d, f, generator=gen, device=dev) / math.sqrt(d)
          ).to(dtype)
    dy = torch.randn(m, f, generator=gen, device=dev).to(dtype)
    grads = []
    for fn in (lambda a, b: ops.grouped_matmul(a, b, gs),
               lambda a, b: ref.grouped_matmul_ref(a, b, gs).to(dtype)):
        x = x0.clone().requires_grad_(True)
        w = w0.clone().requires_grad_(True)
        grads.append(torch.autograd.grad(fn(x, w), (x, w), dy))
    errs = [rel_fro(g, r) for g, r in zip(*grads)]
    # as the forward: fp32 1e-5; bf16 1e-2 (dx rounds to bf16 in both)
    lim = 1e-5 if dtype == torch.float32 else 1e-2
    require(max(errs) <= lim, f"grouped_matmul backward {name} {dtype}: rel "
            f"err dx {errs[0]:.3e} dW {errs[1]:.3e} > {lim:.0e}")
    return {"case": name, "shape": [m, d, f, e],
            "dtype": str(dtype).replace("torch.", ""), "dx_rel_fro_err":
            errs[0], "dw_rel_fro_err": errs[1]}


def phase_grouped_kernels(torch, np, ops, ref, dev="cuda", sizes=SIZES):
    rows = []
    for case in sizes["grouped"]:
        for dtype in (torch.float32, torch.bfloat16):
            timed = case[0] != "ragged" and dtype == torch.bfloat16
            row = check_grouped(torch, np, ops, ref, case, dtype, timed, dev)
            rows.append(row)
            log("grouped_matmul", json.dumps(row))
    back = []
    # a shape refinement differentiates (x @ V of the factorized gate/up
    # bank) and the ragged one
    for case in (sizes["grouped"][2], sizes["grouped"][-1]):
        for dtype in (torch.float32, torch.bfloat16):
            row = check_grouped_backward(torch, np, ops, ref, case, dtype,
                                         dev)
            back.append(row)
            log("grouped_matmul backward", json.dumps(row))
    return rows, back


# ---------------------------------------------------------------------------
# phase 4: smoke recipe on the card against the CPU


def phase_smoke(torch, np, dev="cuda"):
    from repro_torch import configs
    from repro_torch.core import pipeline as P
    from repro_torch.models import model as M

    cfg = configs.get_smoke_config("llama-7b").replace(dtype="float32")
    params = M.init_params(cfg, 0, device="cpu")
    rng = np.random.default_rng(0)
    # 8 x 32 uniform tokens: every tap covariance has full rank, so the
    # solve is well conditioned and the two devices must agree closely
    calib = {"tokens": rng.integers(0, cfg.vocab_size, (8, 32))}
    t = rng.integers(0, cfg.vocab_size, (8, 65))
    batch = {"tokens": torch.from_numpy(t[:, :-1]),
             "labels": torch.from_numpy(t[:, 1:])}
    recipe = P.CompressConfig(ratio=0.6, rank_multiple=1, microbatch=2,
                              calib_mode="fused", refine_epochs=1)
    out = {}
    for name, d in (("card", dev), ("cpu", "cpu")):
        comp, rep = P.compress_model(params, cfg, calib, recipe, device=d)
        with torch.no_grad():
            loss = float(M.loss_fn(comp, cfg, {k: v.to(d)
                                               for k, v in batch.items()})[0])
        out[name] = (comp, rep, loss)
    worst = 0.0
    for part, names in (("attn", ("wq", "wk", "wv", "wo")),
                        ("ffn", ("gate", "up", "down"))):
        for name in names:
            maps = []
            for run in ("card", "cpu"):
                lin = out[run][0]["stages"][0][0][part][name]
                maps.append(torch.einsum("lnk,lkm->lnm", lin["v"].cpu(),
                                         lin["u"].cpu()))
            for layer in range(maps[0].shape[0]):
                worst = max(worst, rel_fro(maps[0][layer], maps[1][layer]))
    lc, lp = out["card"][2], out["cpu"][2]
    log(f"smoke: composed-map rel err (card vs cpu) {worst:.3e}; loss card "
        f"{lc:.6f} cpu {lp:.6f}")
    require(worst <= 1e-3, f"smoke composed maps differ by {worst:.3e}")
    require(abs(lc / lp - 1) <= 1e-3, f"smoke loss {lc} vs {lp}")
    served = phase_smoke_serve(torch, np, cfg, out["cpu"][0], dev)
    return {"map_rel_err": worst, "loss_cuda": lc, "loss_cpu": lp,
            "serve": served}


def phase_smoke_serve(torch, np, cfg, comp, dev):
    """The compressed smoke model (fp32) served on the card (kernels) and
    on the CPU (plain versions) from the same params and prompts."""
    from repro_torch.launch import serve as TS
    from repro_torch.models import model as M

    rng = np.random.default_rng(1)
    prompts = rng.integers(0, cfg.vocab_size, (3, 24), dtype=np.int32)
    lens = (5, 21, 13)
    toks, logits = {}, {}
    for name, d in (("card", dev), ("cpu", "cpu")):
        reqs = [TS.Request(rid=i, prompt=prompts[i, :n], steps=8)
                for i, n in enumerate(lens)]
        eng = TS.ContinuousBatchingServer(cfg, comp, max_len=48, slots=2,
                                          prefill_chunk=8, device=d)
        res = eng.run(reqs)
        fixed = TS.Server(cfg, comp, max_len=48, batch=4, device=d)
        toks[name] = ([res[i]["tokens"].tolist() for i in range(3)],
                      fixed.generate(prompts, steps=8).cpu().tolist())
        # teacher-forced logits over the latent cache: prefill 16, decode 8
        p = fixed.params
        cache = M.init_cache(cfg, 3, 48, params=p, device=d)
        seq = torch.from_numpy(prompts).to(d)
        with torch.inference_mode():
            rows = [M.prefill(p, cfg, {"tokens": seq[:, :16]}, cache)[0]]
            for i in range(16, 24):
                pos = torch.tensor([i, i - 5, i - 11], dtype=torch.int32,
                                   device=d)
                rows.append(M.decode_step(p, cfg, cache, seq[:, i:i + 1],
                                          pos)[0])
        logits[name] = torch.stack(rows).cpu()
    err = rel_fro(logits["card"], logits["cpu"])
    log(f"smoke serve: tokens card {toks['card']} cpu {toks['cpu']}; "
        f"teacher-forced logits rel err (card vs cpu) {err:.3e}")
    require(toks["card"] == toks["cpu"], "smoke serve tokens differ between "
            "the card and the CPU")
    # fp32 on both; kernels sum in another order: 1e-4 relative Frobenius
    require(err <= 1e-4, f"smoke serve logits differ by {err:.3e}")
    return {"tokens": toks["card"], "logits_rel_err": err}


def _dropfree(cfg):
    import dataclasses
    return cfg.replace(moe=dataclasses.replace(cfg.moe, dispatch="dropfree"))


def _composed_maps(torch, block):
    """{path: (..., n, m) composed map v @ u} of every factorized linear of
    a block, expert banks (one map per expert) and shared experts
    included."""
    out = {}
    for part in ("attn", "ffn"):
        for name, lin in block[part].items():
            subs = (lin.items() if name in ("experts", "shared")
                    else [(None, lin)])
            for sub, sl in subs:
                if "u" in sl:
                    key = f"{part}.{name}" + ("" if sub is None else f".{sub}")
                    out[key] = torch.einsum("...nk,...km->...nm",
                                            sl["v"].cpu(), sl["u"].cpu())
    return out


def phase_smoke_moe(torch, np, dev="cuda"):
    """deepseek-v2-lite smoke (fp32, 2 layers) compressed with drop-free
    dispatch on the card and on the CPU from the same params and tokens."""
    from repro_torch import configs
    from repro_torch.core import pipeline as P
    from repro_torch.models import layers as L
    from repro_torch.models import model as M
    from repro_torch.tree import tree_map

    cfg = _dropfree(configs.get_smoke_config("deepseek-v2-lite-16b")
                    .replace(dtype="float32"))
    params = M.init_params(cfg, 0, device="cpu")
    rng = np.random.default_rng(3)
    # 16 x 64 uniform tokens: ~256 routed rows an expert (top-2 of 8) at
    # n = 64, so every expert's covariances have full rank
    calib = {"tokens": rng.integers(0, cfg.vocab_size, (16, 64))}
    t = rng.integers(0, cfg.vocab_size, (8, 65))
    batch = {"tokens": torch.from_numpy(t[:, :-1]),
             "labels": torch.from_numpy(t[:, 1:])}
    recipe = P.CompressConfig(ratio=0.6, rank_multiple=1, microbatch=2,
                              calib_mode="fused", refine_epochs=1,
                              moe_dispatch="dropfree")
    out = {}
    for name, d in (("card", dev), ("cpu", "cpu")):
        # the original stream's routing: the uncompressed model's forward
        # over the calibration tokens, tapped
        store = {}
        pd = tree_map(lambda x, d=d: x.to(d), params)
        with torch.no_grad(), L.sowing(store):
            M.forward_hidden(pd, cfg, {"tokens": torch.from_numpy(
                calib["tokens"]).to(d)})
        ids = store["ffn/experts_ids"].cpu()
        comp, rep = P.compress_model(params, cfg, calib, recipe, device=d)
        with torch.no_grad():
            loss = float(M.loss_fn(comp, cfg, {k: v.to(d) for k, v
                                               in batch.items()})[1]["ce"])
        out[name] = (comp, rep, loss, ids)
    flips = int((out["card"][3] != out["cpu"][3]).sum())
    worst, worst_at = 0.0, None
    for si in range(len(out["cpu"][0]["stages"])):
        maps = [_composed_maps(torch, out[run][0]["stages"][si][0])
                for run in ("card", "cpu")]
        for path, want in maps[1].items():
            got = maps[0][path].reshape(-1, *want.shape[-2:])
            want = want.reshape(-1, *want.shape[-2:])
            for i in range(want.shape[0]):
                err = rel_fro(got[i], want[i])
                if err > worst:
                    worst, worst_at = err, f"stage {si} {path} [{i}]"
    lc, lp = out["card"][2], out["cpu"][2]
    log(f"smoke moe: routed ids {tuple(out['cpu'][3].shape)} flips (card vs "
        f"cpu) {flips}; composed-map rel err {worst:.3e} at {worst_at}; CE "
        f"card {lc:.6f} cpu {lp:.6f}; drop rates "
        f"{out['card'][1]['calibration']['moe_drop_rate']}")
    require(flips == 0, f"smoke moe: {flips} routed expert ids differ "
            "between the card and the CPU")
    # fp32 on both, well-conditioned per-expert covariances: 1e-3 as llama
    require(worst <= 1e-3, f"smoke moe composed maps differ by {worst:.3e} "
            f"({worst_at})")
    require(abs(lc / lp - 1) <= 1e-3, f"smoke moe loss {lc} vs {lp}")
    return {"routed_ids": int(out["cpu"][3].numel()), "id_flips": flips,
            "map_rel_err": worst, "map_worst_at": worst_at, "ce_cuda": lc,
            "ce_cpu": lp}


# ---------------------------------------------------------------------------
# phase 5: the main path at llama-7b's published widths


def solve_pieces(torch, cfg):
    """Device ms of the solve's torch.linalg calls at the main path's
    shapes (one call each after one warm-up): the eighs of the d_model and
    d_ff covariances and the SVDs of the attention and MLP whitened maps."""
    gen = torch.Generator(device="cuda").manual_seed(2)
    d, f = cfg.d_model, cfg.d_ff
    out = {}
    for name, fn, shape in (
            ("eigh_d", lambda a: torch.linalg.eigh(a.T @ a), (d, d)),
            ("eigh_ff", lambda a: torch.linalg.eigh(a.T @ a), (f, f)),
            ("svd_d_x_d", lambda a: torch.linalg.svd(
                a, full_matrices=False), (d, d)),
            ("svd_ff_x_d", lambda a: torch.linalg.svd(
                a, full_matrices=False), (f, d)),
            ("svd_d_x_ff", lambda a: torch.linalg.svd(
                a, full_matrices=False), (d, f))):
        a = torch.randn(*shape, generator=gen, device="cuda")
        out[name] = time_ms(lambda: fn(a), warmup=1, reps=1)
    return out


def phase_main(torch, ops, dev="cuda", sizes=SIZES, cfg=None):
    import repro_torch
    from repro_torch import configs
    from repro_torch.models import model as M

    layers = sizes["layers"]
    if cfg is None:
        cfg = configs.get_config("llama-7b")
    cfg = cfg.replace(num_layers=layers)
    log(f"main: llama-7b widths d_model {cfg.d_model} heads {cfg.num_heads}"
        f"/{cfg.num_kv_heads} head_dim {cfg.head_dim} d_ff {cfg.d_ff} vocab "
        f"{cfg.vocab_size}, dtype {cfg.dtype} params {cfg.param_dtype}; "
        f"num_layers cut 32 -> {layers} for the time limit")
    params = M.init_params(cfg, 0, device=dev)
    gen = torch.Generator(device=dev).manual_seed(1)
    calib = {"tokens": torch.randint(0, cfg.vocab_size, sizes["calib"],
                                     generator=gen, device=dev)}
    evals = []
    n_eval, b_eval, l_eval = sizes["evals"]
    for _ in range(n_eval):
        t = torch.randint(0, cfg.vocab_size, (b_eval, l_eval + 1),
                          generator=gen, device=dev)
        evals.append({"tokens": t[:, :-1], "labels": t[:, 1:]})
    ccfg = repro_torch.CompressConfig(ratio=0.6, calib_mode="fused",
                                      refine_epochs=1,
                                      microbatch=sizes["microbatch"])

    def eval_loss(p):
        with torch.no_grad():
            return [float(M.loss_fn(p, cfg, b)[0]) for b in evals]

    on_card = torch.device(dev).type == "cuda"
    if on_card:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
    ops.reset_launches()
    stages = {}
    t0 = time.perf_counter()
    comp, report = repro_torch.compress_model(params, cfg, calib, ccfg,
                                              device=dev, stage_times=stages)
    t_compress = time.perf_counter() - t0
    t0 = time.perf_counter()
    dense = eval_loss(params)
    compressed = eval_loss(comp)
    stages["eval"] = time.perf_counter() - t0
    launches = dict(ops.LAUNCHES)
    rows = lowrank_rows(ops)
    peak = torch.cuda.max_memory_allocated() if on_card else 0

    log("main: stage seconds", json.dumps(stages))
    log(f"main: compress wall {t_compress:.3f} s, peak device memory "
        f"{peak / 2**30:.3f} GiB")
    log("main: compress_ratio_report",
        json.dumps(repro_torch.compress_ratio_report(params, comp)))
    log("main: launches", json.dumps(launches))
    for u in report["units"]:
        log(f"main: {u['name']} pre/post-refine mse {u['pre_refine_mse']:.6e}"
            f" / {u['post_refine_mse']:.6e}, calib_wall "
            f"{u['calib_wall']:.3f} s, refine_wall {u['refine_wall']:.3f} s,"
            f" ranks {[lin['rank'] for lin in u['linears']]}")
    log(f"main: eval loss dense {dense} compressed {compressed}")
    vals = dense + compressed + [v for u in report["units"]
                                 for v in (u["pre_refine_mse"],
                                           u["post_refine_mse"])]
    require(all(math.isfinite(v) for v in vals), f"non-finite: {vals}")
    for name in ("cov_accum", "lowrank_matmul", "flash_attention"):
        require(launches[name] > 0,
                f"kernel {name} never launched on the compression path")
    if on_card:
        log("main: solve pieces, one call each at the main path's shapes "
            "(ms)", json.dumps(solve_pieces(torch, cfg)))
    lin = comp["stages"][0][0]["attn"]["wq"]
    want_shape = (layers, cfg.d_model, report["units"][0]["linears"][0]
                  ["rank"])
    require(tuple(lin["v"].shape) == want_shape,
            f"factor shape {tuple(lin['v'].shape)} != {want_shape}")
    return {"stages": stages, "launches": launches,
            "lowrank_rows": rows, "peak_bytes": peak,
            "dense": dense, "compressed": compressed}, cfg, params, comp


# ---------------------------------------------------------------------------
# phase 6: serving at llama-7b widths


def _cache_bytes(M, cfg, slots, max_len, params):
    cache = M.init_cache(cfg, slots, max_len, params=params, device="meta")
    leaves = []
    for per_kind in cache:
        for c in per_kind:
            leaves += list(c.values())
    return sum(t.numel() * t.element_size() for t in leaves)


def _sync(torch, dev):
    if torch.device(dev).type == "cuda":
        torch.cuda.synchronize()


def phase_serve(torch, np, ops, cfg, params, comp, dev="cuda", sizes=SIZES):
    from repro_torch.launch import serve as TS
    from repro_torch.models import model as M

    on_card = torch.device(dev).type == "cuda"
    rng = np.random.default_rng(7)
    out = {}

    # (a) fixed batch, dense cache: flash_attention for prefill and decode
    b, plen, steps, max_len = sizes["serve_dense"]
    prompts = rng.integers(0, cfg.vocab_size, (b, plen), dtype=np.int32)
    srv = TS.Server(cfg, params, max_len=max_len, batch=b, device=dev)
    _sync(torch, dev)
    ops.reset_launches()
    t0 = time.perf_counter()
    first = srv.generate(prompts, steps=1).cpu()
    t_prefill = time.perf_counter() - t0
    t0 = time.perf_counter()
    toks = srv.generate(prompts, steps=steps).cpu()
    t_all = time.perf_counter() - t0
    launches = dict(ops.LAUNCHES)
    require(launches["flash_attention"] > 0,
            "flash_attention never launched by Server.generate")
    require(tuple(toks.shape) == (b, steps) and torch.equal(toks[:, :1],
                                                            first)
            and bool(((toks >= 0) & (toks < cfg.vocab_size)).all()),
            f"Server tokens malformed: {tuple(toks.shape)}")
    decode_s = t_all - t_prefill
    out["server"] = {
        "launches": launches, "lowrank_rows": lowrank_rows(ops),
        "prefill_s": t_prefill,
        "prefill_tokens_per_s": b * plen / t_prefill,
        "decode_tokens_per_s": b * (steps - 1) / decode_s,
        "decode_step_ms": decode_s / (steps - 1) * 1e3,
        "generate_s": t_all, "tokens_head": toks[:, :8].tolist()}
    log("serve (a) Server dense:", json.dumps(out["server"]))

    # (b) continuous batching over the latent cache
    slots, max_len, chunk, n_req, (lo, hi), steps = sizes["serve_engine"]
    lens = rng.integers(lo, hi + 1, n_req)
    reqs = [TS.Request(rid=i, prompt=rng.integers(0, cfg.vocab_size, (n,),
                                                  dtype=np.int32),
                       steps=steps) for i, n in enumerate(lens)]
    eng = TS.ContinuousBatchingServer(cfg, comp, max_len=max_len,
                                      slots=slots, prefill_chunk=chunk,
                                      device=dev)
    _sync(torch, dev)
    if on_card:
        torch.cuda.reset_peak_memory_stats()
    ops.reset_launches()
    t0 = time.perf_counter()
    res = eng.run(reqs)
    wall = time.perf_counter() - t0
    launches = dict(ops.LAUNCHES)
    peak = torch.cuda.max_memory_allocated() if on_card else 0
    for name in ("flash_attention", "flash_decode", "lowrank_matmul"):
        require(launches[name] > 0,
                f"kernel {name} never launched on the serving path")
    require(sorted(res) == list(range(n_req)) and all(
        len(r["tokens"]) == steps and ((r["tokens"] >= 0)
                                       & (r["tokens"] < cfg.vocab_size)).all()
        for r in res.values()), "engine results malformed")
    require(set(eng.prefill_routes.values()) == {"chunked"},
            f"prefill routes {eng.prefill_routes}")
    ttft = [res[i]["first_token"] - res[i]["arrival"] for i in range(n_req)]
    prefill_s = [res[i]["first_token"] - res[i]["admitted"]
                 for i in range(n_req)]
    times = eng.decode_step_times
    latent = _cache_bytes(M, cfg, slots, max_len, eng.params)
    dense = _cache_bytes(M, cfg, slots, max_len, None)
    out["engine"] = {
        "launches": launches, "lowrank_rows": lowrank_rows(ops),
        "wall_s": wall, "requests": n_req,
        "prompt_lens": lens.tolist(),
        "ttft_s_median": statistics.median(ttft), "ttft_s_max": max(ttft),
        "ttft_s_first_slots_median": statistics.median(ttft[:slots]),
        "prefill_tokens_per_s": float(sum(lens)) / sum(prefill_s),
        "decode_steps": len(times),
        "decode_step_ms_median": statistics.median(times) * 1e3,
        "decode_tokens_per_s": n_req * (steps - 1) / sum(times),
        "cache_bytes_latent": latent, "cache_bytes_dense": dense,
        "peak_bytes": peak}
    log("serve (b) engine latent:", json.dumps(out["engine"]))

    # (b') the same requests with the dense layout forced: flash_attention
    # decode over bf16 k/v against flash_decode over the latents
    eng_dense = TS.ContinuousBatchingServer(cfg, comp, max_len=max_len,
                                            slots=slots, prefill_chunk=chunk,
                                            cache_layout="dense", device=dev)
    _sync(torch, dev)
    ops.reset_launches()
    t0 = time.perf_counter()
    res_d = eng_dense.run(reqs)
    wall = time.perf_counter() - t0
    times = eng_dense.decode_step_times
    same = sum(int((res_d[i]["tokens"] == res[i]["tokens"]).sum())
               for i in range(n_req))
    out["engine_dense"] = {
        "launches": dict(ops.LAUNCHES), "lowrank_rows": lowrank_rows(ops),
        "wall_s": wall,
        "decode_step_ms_median": statistics.median(times) * 1e3,
        "decode_tokens_per_s": n_req * (steps - 1) / sum(times),
        "tokens_equal_to_latent": same / (n_req * steps)}
    log("serve (b') engine dense:", json.dumps(out["engine_dense"]))

    # (c) one teacher-forced sequence: latent-cache decode against
    # dense-cache decode, and chunked against whole prefill
    plen, n_dec, max_len = sizes["serve_check"]
    p = eng.params
    seq = torch.from_numpy(rng.integers(0, cfg.vocab_size, (1, plen + n_dec),
                                        dtype=np.int32)).to(dev)
    logits = {}
    with torch.inference_mode():
        for layout in ("latent", "dense"):
            cache = M.init_cache(cfg, 1, max_len, params=p if layout ==
                                 "latent" else None, device=dev)
            rows = [M.prefill(p, cfg, {"tokens": seq[:, :plen]}, cache)[0]]
            for i in range(plen, plen + n_dec):
                pos = torch.tensor([i], dtype=torch.int32, device=dev)
                rows.append(M.decode_step(p, cfg, cache, seq[:, i:i + 1],
                                          pos)[0])
            logits[layout] = torch.cat(rows)
        # chunked against whole prefill of plen tokens (a last chunk of
        # `chunk` rows) and of plen + 8 (a last chunk of 8 rows, decode's
        # row count): the last row's logits
        def new_cache(layout):
            return M.init_cache(cfg, 1, max_len, params=p if layout ==
                                "latent" else None, device=dev)

        err_chunk = {}
        for layout in ("latent", "dense"):
            for tail in (0, 8):
                cache, end = new_cache(layout), plen + tail
                for c0 in range(0, end, chunk):
                    last, cache = M.prefill(
                        p, cfg, {"tokens": seq[:, c0:min(end, c0 + chunk)]},
                        cache, pos=c0, chunked=True)
                whole = (logits[layout][:1] if tail == 0 else M.prefill(
                    p, cfg, {"tokens": seq[:, :end]}, new_cache(layout))[0])
                key = layout if tail == 0 else f"{layout}_last_chunk_{tail}"
                err_chunk[key] = rel_fro(last, whole)
        # the same two routes with fp32 activations: both caches then hold
        # unrounded keys and values, so they must agree to fp32 rounding
        cfg32 = cfg.replace(dtype="float32")
        for layout in ("latent32", "dense32"):
            cache = M.init_cache(cfg32, 1, max_len, params=p if layout ==
                                 "latent32" else None, device=dev)
            rows = [M.prefill(p, cfg32, {"tokens": seq[:, :plen]}, cache)[0]]
            for i in range(plen, plen + n_dec):
                pos = torch.tensor([i], dtype=torch.int32, device=dev)
                rows.append(M.decode_step(p, cfg32, cache, seq[:, i:i + 1],
                                          pos)[0])
            logits[layout] = torch.cat(rows)
    err_decode = rel_fro(logits["latent"][1:], logits["dense"][1:])
    err_decode32 = rel_fro(logits["latent32"][1:], logits["dense32"][1:])
    err_bf16 = {k: rel_fro(logits[k][1:], logits["dense32"][1:])
                for k in ("latent", "dense")}
    err_prefill = rel_fro(logits["latent"][:1], logits["dense"][:1])
    out["checks"] = {"latent_vs_dense_decode": err_decode,
                     "latent_vs_dense_decode_fp32": err_decode32,
                     "bf16_vs_fp32_decode": err_bf16,
                     "latent_vs_dense_prefill": err_prefill,
                     "chunked_vs_whole": err_chunk}
    log("serve (c) checks (rel Frobenius):", json.dumps(out["checks"]))
    # bf16 activations: the latent path keeps keys and values unrounded in
    # fp32 (U fp32 in flash_decode), the dense path stores them in bf16, so
    # the two differ by bf16 rounding carried through 2 layers; each bf16
    # route is 7.2-7.6 % from the fp32 one on these random weights (this
    # script on an H100, "bf16_vs_fp32_decode" above): 1e-1.  Chunked
    # prefill runs each row through the same kernels in the same tile
    # order (prefill takes lowrank_matmul's large-T body at any row count:
    # ops.batch_invariant); only the cuBLAS latent projection sees another
    # row count: 1e-2
    require(err_decode <= 1e-1, f"latent vs dense decode {err_decode:.3e}")
    # fp32 activations: the same function through two kernels, sums in
    # another order: 1e-4
    require(err_decode32 <= 1e-4,
            f"latent vs dense decode in fp32 {err_decode32:.3e}")
    require(err_prefill <= 1e-1,
            f"latent vs dense prefill {err_prefill:.3e}")
    for k, v in err_chunk.items():
        require(v <= 1e-2, f"chunked vs whole prefill ({k}) {v:.3e}")
    if on_card:
        out["profile"] = {layout: profile_engine(torch, np, TS, cfg, comp,
                                                 layout, sizes)
                          for layout in ("auto", "dense")}
        log("serve (d) device time by kernel:", json.dumps(out["profile"]))
    return out


def profile_engine(torch, np, TS, cfg, comp, layout, sizes):
    """Device time by kernel of a short engine run (8 slots, 256-token
    prompts, 16 steps) under ``torch.profiler`` (device activity only), and
    the device's busy share of the same run's wall time without the
    profiler."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    slots, max_len, chunk = sizes["serve_engine"][:3]
    rng = np.random.default_rng(11)
    reqs = [TS.Request(rid=i, prompt=rng.integers(0, cfg.vocab_size, (256,),
                                                  dtype=np.int32), steps=16)
            for i in range(slots)]
    eng = TS.ContinuousBatchingServer(cfg, comp, max_len=max_len,
                                      slots=slots, prefill_chunk=chunk,
                                      cache_layout=layout, device="cuda")
    eng.run(reqs)                                   # warm-up
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    eng.run(reqs)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    step_ms = statistics.median(eng.decode_step_times) * 1e3
    t0 = time.perf_counter()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        eng.run(reqs)
        torch.cuda.synchronize()
    wall_profiled = time.perf_counter() - t0
    kernels = {}            # device activity only (kernels, copies), ms
    for evt in prof.key_averages():
        if evt.device_type == DeviceType.CUDA:
            kernels[evt.key[:80]] = evt.self_device_time_total / 1e3
    busy = sum(kernels.values())
    top = dict(sorted(kernels.items(), key=lambda kv: -kv[1])[:10])
    return {"wall_ms": wall * 1e3, "wall_ms_profiled": wall_profiled * 1e3,
            "device_busy_ms": busy, "busy_share": busy / (wall * 1e3),
            "decode_step_ms_median": step_ms, "top_kernels_ms": top}


# ---------------------------------------------------------------------------
# phase 7: drop-free MoE compression at deepseek-v2-lite's published widths


def moe_solve_pieces(torch, cfg):
    """Device ms of one call each (after one warm-up) of the solve's
    torch.linalg work per expert and for the dense-first FFN: the eighs of
    the d_model, expert d_ff and dense d_ff covariances, the SVDs of an
    expert's whitened (d_ff, d_model) / (d_model, d_ff) maps and of the
    dense FFN's (dense d_ff, d_model) map."""
    gen = torch.Generator(device="cuda").manual_seed(5)
    d, f, fd = cfg.d_model, cfg.moe.d_ff, cfg.moe.dense_d_ff
    out = {}
    for name, fn, shape in (
            ("eigh_d", lambda a: torch.linalg.eigh(a.T @ a), (d, d)),
            ("eigh_expert_ff", lambda a: torch.linalg.eigh(a.T @ a), (f, f)),
            ("eigh_dense_ff", lambda a: torch.linalg.eigh(a.T @ a), (fd, fd)),
            ("svd_expert_ff_x_d", lambda a: torch.linalg.svd(
                a, full_matrices=False), (f, d)),
            ("svd_expert_d_x_ff", lambda a: torch.linalg.svd(
                a, full_matrices=False), (d, f)),
            ("svd_dense_ff_x_d", lambda a: torch.linalg.svd(
                a, full_matrices=False), (fd, d))):
        a = torch.randn(*shape, generator=gen, device="cuda")
        out[name] = time_ms(lambda: fn(a), warmup=1, reps=1)
    return out


def moe_forward_syncs(torch, cfg, comp, batch):
    """Run the compressed MoE layer's forward (router, drop-free dispatch,
    three factorized ``grouped_matmul`` banks, shared experts) on phase 7's
    microbatch under ``torch.cuda.set_sync_debug_mode("error")``, which
    raises on any operation that synchronizes the host with the card:
    nothing of the routing may be read on the host."""
    from repro_torch.models import layers as L
    from repro_torch.models import mlp as MLP

    p = comp["stages"][1][0]["ffn"]
    x = L.embed(comp["embed"], batch["tokens"], torch.bfloat16)
    with torch.no_grad():
        MLP.moe_apply(p, x, cfg)              # warm-up, outside the check
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("error")
        try:
            y, aux = MLP.moe_apply(p, x, cfg)
            err = None
        except RuntimeError as exc:
            err = str(exc)[:300]
        finally:
            torch.cuda.set_sync_debug_mode("default")
        torch.cuda.synchronize()
    require(err is None, f"the MoE forward synchronized the host: {err}")
    require(bool(torch.isfinite(y).all()) and math.isfinite(float(aux)),
            "the MoE forward under the sync check is not finite")
    return {"mode": "error", "raised": err, "shape": list(x.shape)}


def eval_busy_share(torch, M, cfg, params, batch):
    """The device's busy share of one eval forward: device time of its
    kernels under ``torch.profiler`` (device activity only) over the wall
    time of the same forward without the profiler."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    def run():
        with torch.no_grad():
            M.loss_fn(params, cfg, batch)
        torch.cuda.synchronize()

    run()
    t0 = time.perf_counter()
    run()
    wall = (time.perf_counter() - t0) * 1e3
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        run()
    kernels = {}
    for evt in prof.key_averages():
        if evt.device_type == DeviceType.CUDA:
            kernels[evt.key[:80]] = evt.self_device_time_total / 1e3
    busy = sum(kernels.values())
    top = dict(sorted(kernels.items(), key=lambda kv: -kv[1])[:8])
    return {"wall_ms": wall, "device_busy_ms": busy,
            "busy_share": busy / wall, "top_kernels_ms": top}


def phase_moe(torch, ops, dev="cuda", sizes=SIZES, cfg=None):
    import repro_torch
    from repro_torch import configs
    from repro_torch.models import model as M

    layers = sizes["moe_layers"]
    if cfg is None:
        cfg = configs.get_config("deepseek-v2-lite-16b")
    cfg = _dropfree(cfg.replace(num_layers=layers))
    m = cfg.mla
    log(f"moe: deepseek-v2-lite widths d_model {cfg.d_model} heads "
        f"{cfg.num_heads}, MLA kv_lora {m.kv_lora_rank} nope "
        f"{m.qk_nope_head_dim} rope {m.qk_rope_head_dim} v {m.v_head_dim}, "
        f"{cfg.moe.num_experts} experts top-{cfg.moe.top_k} d_ff "
        f"{cfg.moe.d_ff} + {cfg.moe.num_shared_experts} shared, dense d_ff "
        f"{cfg.moe.dense_d_ff}, vocab {cfg.vocab_size}, dtype {cfg.dtype} "
        f"params {cfg.param_dtype}, dispatch {cfg.moe.dispatch}; num_layers "
        f"cut 27 -> {layers} for the time limit")
    params = M.init_params(cfg, 0, device=dev)
    gen = torch.Generator(device=dev).manual_seed(1)
    calib = {"tokens": torch.randint(0, cfg.vocab_size, sizes["calib"],
                                     generator=gen, device=dev)}
    evals = []
    n_eval, b_eval, l_eval = sizes["evals"]
    for _ in range(n_eval):
        t = torch.randint(0, cfg.vocab_size, (b_eval, l_eval + 1),
                          generator=gen, device=dev)
        evals.append({"tokens": t[:, :-1], "labels": t[:, 1:]})
    ccfg = repro_torch.CompressConfig(ratio=0.6, calib_mode="fused",
                                      refine_epochs=1,
                                      microbatch=sizes["microbatch"],
                                      moe_dispatch="dropfree")

    def eval_loss(p):
        with torch.no_grad():
            return [float(M.loss_fn(p, cfg, b)[1]["ce"]) for b in evals]

    on_card = torch.device(dev).type == "cuda"
    if on_card:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
    ops.reset_launches()
    stages = {}
    t0 = time.perf_counter()
    comp, report = repro_torch.compress_model(params, cfg, calib, ccfg,
                                              device=dev, stage_times=stages)
    t_compress = time.perf_counter() - t0
    t0 = time.perf_counter()
    dense = eval_loss(params)
    compressed = eval_loss(comp)
    stages["eval"] = time.perf_counter() - t0
    launches = dict(ops.LAUNCHES)
    rows = lowrank_rows(ops)
    peak = torch.cuda.max_memory_allocated() if on_card else 0

    ratio = repro_torch.compress_ratio_report(params, comp)
    log("moe: stage seconds", json.dumps(stages))
    log(f"moe: compress wall {t_compress:.3f} s, peak device memory "
        f"{peak / 2**30:.3f} GiB")
    log("moe: compress_ratio_report", json.dumps(ratio))
    log("moe: launches", json.dumps(launches))
    log("moe: calibration", json.dumps(
        {k: report["calibration"][k] for k in
         ("mode", "tapped_forwards", "moe_dispatch", "moe_drop_rate")}))
    ranks = {}
    for u in report["units"]:
        log(f"moe: {u['name']} pre/post-refine mse {u['pre_refine_mse']:.6e}"
            f" / {u['post_refine_mse']:.6e}, calib_wall "
            f"{u['calib_wall']:.3f} s, refine_wall {u['refine_wall']:.3f} s")
        ranks.update({lin["path"]: lin["rank"] for lin in u["linears"]})
    log("moe: ranks", json.dumps(ranks))
    log(f"moe: eval CE dense {dense} compressed {compressed}")
    vals = dense + compressed + [v for u in report["units"]
                                 for v in (u["pre_refine_mse"],
                                           u["post_refine_mse"])]
    require(all(math.isfinite(v) for v in vals), f"non-finite: {vals}")
    for name in ("grouped_matmul", "cov_accum", "lowrank_matmul",
                 "flash_attention"):
        require(launches[name] > 0,
                f"kernel {name} never launched on the MoE compression path")
    want_ranks = {"attn.wq": 744, "attn.wkv_a": 272, "attn.wk_b": 248,
                  "attn.wv_b": 248, "attn.wo": 616, "ffn.gate": 1040,
                  "ffn.experts.gate": 504, "ffn.experts.down": 504,
                  "ffn.shared.up": 712}
    if cfg.d_model == 2048:     # the published widths (PERF.md's table)
        require(all(ranks.get(k) == v for k, v in want_ranks.items()),
                f"ranks {ranks} differ from {want_ranks}")
    k = ranks["ffn.experts.gate"]
    bank = comp["stages"][1][0]["ffn"]["experts"]["gate"]
    require(tuple(bank["v"].shape) == (cfg.moe.num_experts, cfg.d_model, k)
            and tuple(bank["u"].shape) == (cfg.moe.num_experts, k,
                                           cfg.moe.d_ff),
            f"expert factors {tuple(bank['v'].shape)} / "
            f"{tuple(bank['u'].shape)}")
    extra = {}
    if on_card:
        extra["host_syncs"] = moe_forward_syncs(torch, cfg, comp, evals[0])
        log("moe: host syncs in the compressed MoE layer's forward "
            "(torch.cuda.set_sync_debug_mode)", json.dumps(extra["host_syncs"]))
        extra["solve_pieces_ms"] = moe_solve_pieces(torch, cfg)
        log("moe: solve pieces, one call each at the MoE path's shapes (ms)",
            json.dumps(extra["solve_pieces_ms"]))
        extra["eval_profile"] = eval_busy_share(torch, M, cfg, comp,
                                                evals[0])
        log("moe: compressed eval forward, device time by kernel",
            json.dumps(extra["eval_profile"]))
    return {"stages": stages, "launches": launches,
            "lowrank_rows": rows, "peak_bytes": peak,
            "compress_wall_s": t_compress, "ratio": ratio, "ranks": ranks,
            "dense": dense, "compressed": compressed, **extra}


# ---------------------------------------------------------------------------


def main(argv=None) -> int:
    import argparse
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--only", choices=("lowrank",),
                    help="phases 1-2 and lowrank_matmul's rows of phase 3")
    args = ap.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    if not (SRC / "repro_torch").is_dir():
        print(f"chip_smoke: {SRC / 'repro_torch'} not found; run from the "
              "repository root", file=sys.stderr)
        return 2
    sys.path.insert(0, str(SRC))
    OUT.mkdir(exist_ok=True)
    global LOG
    # a partial run (--only) names its log after its part
    tag = "" if args.only is None else f"_{args.only}"
    LOG = OUT / f"chip_smoke{tag}.log"
    LOG.write_text("")
    import numpy as np

    import repro_torch  # noqa: F401  (turns TF32 off)
    from repro_torch.kernels import build, ops, ref

    # 1. device
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60)
    card = smi.stdout.strip().splitlines()[0] if smi.stdout.strip() else ""
    require(card, f"nvidia-smi gave nothing: {smi.stderr}")
    print(card, flush=True)
    log(f"device: {torch.cuda.get_device_name(0)} x "
        f"{torch.cuda.device_count()}; torch {torch.__version__} cuda "
        f"{torch.version.cuda}; tf32 {torch.backends.cuda.matmul.allow_tf32}")

    # 2. build
    t0 = time.perf_counter()
    build.library()
    log(f"build: {time.perf_counter() - t0:.3f} s ({build.library_path()})")
    nvcc = subprocess.run([build._nvcc(), "--version"], capture_output=True,
                          text=True, timeout=60).stdout.strip().splitlines()
    log("build: nvcc", nvcc[-1] if nvcc else "?")
    for line in build.build_log().splitlines():
        if "registers" in line or "spill" in line or "Compiling" in line:
            log("build:", line.strip())
    from repro_torch.kernels import lowrank_matmul as low
    hgmma = sass_report(build.library_path())
    if hgmma is None:
        log("sass: cuobjdump not found; HGMMA not checked")
    else:
        wg = {fn: c for fn, c in hgmma.items() if "wgmma" in fn}
        log("sass: HGMMA instructions by kernel:", json.dumps(
            {fn: c for fn, c in hgmma.items() if c} or "none"))
        require(wg and all(wg.values()),
                f"the wgmma body's SASS holds no HGMMA: {wg}")
    if args.only == "lowrank":
        rows = phase_lowrank(torch, ops, ref)
        with open(OUT / f"chip_smoke{tag}.json", "w") as f:
            json.dump({"card": card, "lowrank_matmul": rows},
                      f, indent=1)
        print(json.dumps({"ok": True, "device": {
            "platform": "gpu", "kind": torch.cuda.get_device_name(0),
            "count": torch.cuda.device_count()}}), flush=True)
        return 0

    # 3. kernels
    t0 = time.perf_counter()
    cov_rows, low_rows = phase_kernels(torch, ops, ref)
    fa_rows, fd_rows = phase_attention_kernels(torch, np, ops, ref)
    gm_rows, gm_back = phase_grouped_kernels(torch, np, ops, ref)
    log(f"phase 3: {time.perf_counter() - t0:.3f} s")
    # 4. smoke parity
    t0 = time.perf_counter()
    smoke = phase_smoke(torch, np)
    smoke["moe"] = phase_smoke_moe(torch, np)
    log(f"phase 4: {time.perf_counter() - t0:.3f} s")
    # 5. main path: compression
    t0 = time.perf_counter()
    main_run, cfg, params, comp = phase_main(torch, ops)
    log(f"phase 5: {time.perf_counter() - t0:.3f} s")
    # 6. main path: serving
    t0 = time.perf_counter()
    serve_run = phase_serve(torch, np, ops, cfg, params, comp)
    log(f"phase 6: {time.perf_counter() - t0:.3f} s")
    del params, comp
    torch.cuda.empty_cache()
    # 7. MoE path: drop-free compression of deepseek-v2-lite
    t0 = time.perf_counter()
    moe_run = phase_moe(torch, ops)
    log(f"phase 7: {time.perf_counter() - t0:.3f} s")

    def timing(row):
        return {"max_abs_err": row["max_abs_err"], "ms": row["ms"],
                "plain_ms": row["plain_ms"], "bound_ms": row["bound_ms"],
                "bound_by": row["bound_by"], "library_ms": row["library_ms"],
                "shape": row["shape"], "dtype": row["dtype"],
                **{key: row[key] for key in ("device_ms", "library_device_ms")
                   if key in row}}

    def entry(name, source, replaces, rows, path):
        head = next(r for r in rows if "ms" in r)
        by_path = {"compress": main_run["launches"][name],
                   "serve_server": serve_run["server"]["launches"][name],
                   "serve_engine": serve_run["engine"]["launches"][name],
                   "compress_moe": moe_run["launches"][name]}
        return {"name": name, "route": "cuda", "source": source,
                "replaces": replaces, "launches": by_path[path],
                "launches_by_path": by_path, **timing(head)}

    kernels = [
        entry("cov_accum", "src/repro_torch/csrc/cov_accum.cu",
              "src/repro/kernels/cov_accum.py:59", cov_rows, "compress"),
        entry("lowrank_matmul", "src/repro_torch/csrc/lowrank_matmul.cu",
              "src/repro/kernels/lowrank_matmul.py:63", low_rows,
              "compress"),
        entry("flash_attention", "src/repro_torch/csrc/flash_attention.cu",
              "src/repro/kernels/flash_attention.py:79", fa_rows,
              "serve_engine"),
        entry("flash_decode", "src/repro_torch/csrc/flash_decode.cu",
              "src/repro/kernels/flash_decode.py:98", fd_rows,
              "serve_engine"),
        entry("grouped_matmul", "src/repro_torch/csrc/grouped_matmul.cu",
              "src/repro/kernels/grouped_matmul.py:105", gm_rows,
              "compress_moe"),
    ]
    # lowrank_matmul's other bodies, where the engine runs them: decode's
    # T 8 (small_t) and the prefill chunk's T 256 (wgmma, split), and its
    # launches on each path by row count
    low = next(k for k in kernels if k["name"] == "lowrank_matmul")
    for key, t_rows in (("decode_T8", 8), ("chunk_T256", 256)):
        low[key] = timing(next(r for r in low_rows if "ms" in r
                               and r["shape"][0] == t_rows
                               and not r["forced"]))
        low[key]["body"] = next(
            r["body"] for r in low_rows if "ms" in r
            and r["shape"][0] == t_rows and not r["forced"])
    low["launches_by_rows"] = {
        "compress": main_run["lowrank_rows"],
        "serve_server": serve_run["server"]["lowrank_rows"],
        "serve_engine": serve_run["engine"]["lowrank_rows"],
        "compress_moe": moe_run["lowrank_rows"]}
    # MLA prefill's head dim: the flash_attention instance phase 7 runs
    next(k for k in kernels if k["name"] == "flash_attention")[
        "mla_prefill_d192"] = timing(next(
            r for r in fa_rows if r["case"] == "mla_prefill" and "ms" in r))
    with open(OUT / "chip_smoke.json", "w") as f:
        json.dump({"card": card, "cov_accum": cov_rows,
                   "lowrank_matmul": low_rows, "flash_attention": fa_rows,
                   "flash_decode": fd_rows, "grouped_matmul": gm_rows,
                   "grouped_matmul_backward": gm_back, "smoke": smoke,
                   "main": main_run, "serve": serve_run, "moe": moe_run},
                  f, indent=1)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
