#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port of AA-SVD (``src/repro_torch``) on one GPU.

    python3 chip_smoke.py            # from the repository root, one CUDA card

Phases, each fatal on failure (non-zero exit, no result line):

1. device  — needs CUDA; prints the card's name and power limit.
2. build   — compiles the hand-written kernels (``src/repro_torch/csrc``).
3. kernels — every kernel against its plain PyTorch version on the card, at
             the main path's shapes and ragged ones, with times (CUDA
             events, median of 10 runs after warm-up), the plain version's
             time, one PyTorch yardstick (``library_ms``) and the card's
             least time for the same work (``bound_ms``).
4. smoke   — the smoke compression recipe on the card (kernels) and on the
             CPU (plain versions) from the same params and tokens.
5. main    — Algorithm 2 on llama-7b at its published widths, depth cut to
             2 layers, random weights from a seeded ``torch.Generator``:
             calibration 8 × 1024 tokens, ratio 0.6, fused calibration, one
             refine epoch; then the dense and compressed eval losses.  The
             kernels' launch counts are zeroed just before and read just
             after, and must all be > 0.

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
    "layers": 2,
    "calib": (8, 1024),
    "microbatch": 4,
    "evals": (2, 4, 1024),
}


class PhaseError(RuntimeError):
    pass


def log(*args):
    line = " ".join(str(a) for a in args)
    print(line, flush=True)
    with open(OUT / "chip_smoke.log", "a") as f:
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
                  dev):
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
    got = ops.lowrank_matmul(x, v, u, bias=bias, residual=res)
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
    row = {"shape": [t_rows, n, k, m], "dtype": str(dtype)
           .replace("torch.", ""), "epilogue": epilogue, "err": err,
           "max_abs_err": mae}
    if timed:
        row["ms"] = time_ms(lambda: ops.lowrank_matmul(
            x, v, u, bias=bias, residual=res))
        row["plain_ms"] = time_ms(lambda: ref.lowrank_matmul_ref(x, v, u))
        row["library_ms"] = time_ms(lambda: torch.matmul(
            torch.matmul(x, v), u))
        eb = x.element_size()
        flops = 2 * t_rows * k * (n + m)
        nbytes = (t_rows * n + n * k + k * m + t_rows * m) * eb
        if epilogue:
            nbytes += (m + t_rows * m) * eb
        row["bound_ms"], row["bound_by"] = bound(flops, nbytes,
                                                 row["dtype"])
    return row


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
    for i, (n, k, m) in enumerate(sizes["lowrank_nkm"]):
        for dtype in (torch.float32, torch.bfloat16):
            for epilogue in (False, True):
                timed = (i < len(sizes["lowrank_nkm"]) - 1
                         and dtype == torch.bfloat16 and not epilogue)
                row = check_lowrank(torch, ops, ref, t_rows, n, k, m, dtype,
                                    epilogue, timed, dev)
                low_rows.append(row)
                log("lowrank_matmul", json.dumps(row))
    return cov_rows, low_rows


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
    return {"map_rel_err": worst, "loss_cuda": lc, "loss_cpu": lp}


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
    for name, count in launches.items():
        require(count > 0, f"kernel {name} never launched on the main path")
    if on_card:
        log("main: solve pieces, one call each at the main path's shapes "
            "(ms)", json.dumps(solve_pieces(torch, cfg)))
    lin = comp["stages"][0][0]["attn"]["wq"]
    want_shape = (layers, cfg.d_model, report["units"][0]["linears"][0]
                  ["rank"])
    require(tuple(lin["v"].shape) == want_shape,
            f"factor shape {tuple(lin['v'].shape)} != {want_shape}")
    return {"stages": stages, "launches": launches, "peak_bytes": peak,
            "dense": dense, "compressed": compressed}


# ---------------------------------------------------------------------------


def main() -> int:
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
    (OUT / "chip_smoke.log").write_text("")
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
    for line in build.build_log().splitlines():
        if "registers" in line or "spill" in line or "Compiling" in line:
            log("build:", line.strip())

    # 3. kernels
    cov_rows, low_rows = phase_kernels(torch, ops, ref)
    # 4. smoke parity
    smoke = phase_smoke(torch, np)
    # 5. main path
    main_run = phase_main(torch, ops)

    def entry(name, source, replaces, rows):
        head = next(r for r in rows if "ms" in r)
        return {"name": name, "route": "cuda", "source": source,
                "replaces": replaces,
                "launches": main_run["launches"][name],
                "max_abs_err": head["max_abs_err"], "ms": head["ms"],
                "plain_ms": head["plain_ms"], "bound_ms": head["bound_ms"],
                "bound_by": head["bound_by"],
                "library_ms": head["library_ms"],
                "shape": head["shape"], "dtype": head["dtype"]}

    kernels = [
        entry("cov_accum", "src/repro_torch/csrc/cov_accum.cu",
              "src/repro/kernels/cov_accum.py:59", cov_rows),
        entry("lowrank_matmul", "src/repro_torch/csrc/lowrank_matmul.cu",
              "src/repro/kernels/lowrank_matmul.py:63", low_rows),
    ]
    with open(OUT / "chip_smoke.json", "w") as f:
        json.dump({"card": card, "cov_accum": cov_rows,
                   "lowrank_matmul": low_rows, "smoke": smoke,
                   "main": {k: v for k, v in main_run.items()}}, f, indent=1)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
