"""Algorithm 2: end-to-end block-wise AA-SVD compression with refinement.

Counterpart of ``src/repro/core/pipeline.py`` for ``rank_mode="uniform"``,
``calib_mode`` "fused" or "sequential", ``calib_mesh=None``, on dense GQA
models (llama, qwen3, granite, phi3-medium; gemma3's sliding-window local
and global layers) and on deepseek's MLA + MoE (capacity or drop-free
dispatch).  The model is
unrolled into units (one transformer block each; stacked stages are sliced
and restacked afterwards).  Per unit:

  1. calibration statistics via the streaming engine (``core.streaming``):
     every tap group (q/k/v share a tap, gate/up share) owns a covariance
     triple {XᵀX, XᵀX', X'ᵀX'}, X from the ORIGINAL unit on the original
     stream and X' from the partially compressed unit on the shifted
     stream, accumulated by the ``cov_accum`` CUDA kernel (per expert for
     the MoE's bank taps: one banked launch over the capacity buffers, or
     one launch an expert segment of the drop-free dispatch's rows).  Then solve Thm 3.2 per linear (per
     expert for a bank) and swap the weight for its (U, V) factors.
  2. block-level refinement (``core.refine``) against the original outputs.
  3. propagate both streams: X ← L_i(X) with original weights,
     X' ← L'_i(X') with compressed weights (factorized linears run the
     ``lowrank_matmul`` CUDA kernel; expert banks batched products under
     the capacity dispatch, ``grouped_matmul`` under the drop-free one).

``compress_model`` runs on the card unless the caller passes
``device="cpu"``, where the kernels' plain versions run instead.  The
caller's params are never modified.
"""

from __future__ import annotations

import contextlib
import dataclasses
import logging
import time
from typing import Any, Dict, List, NamedTuple, Optional, Tuple

import numpy as np
import torch

from repro_torch.core import calibration as C
from repro_torch.core import lowrank as LR
from repro_torch.core import ranks as R
from repro_torch.core import refine as RF
from repro_torch.core import streaming as S
from repro_torch.device import resolve_device
from repro_torch.models import blocks as B
from repro_torch.models import layers as L
from repro_torch.models import model as M
from repro_torch.tree import tree_leaves, tree_map

LOG = logging.getLogger(__name__)


@dataclasses.dataclass(frozen=True)
class CompressConfig:
    """Knobs for ``compress_model`` (Algorithm 2); every field and default of
    the JAX package's ``CompressConfig``.

    Ported: ``rank_mode="uniform"``, ``calib_mode`` "fused" and
    "sequential", ``calib_mesh=None``, every objective, eigh and cholesky
    whitening, the ``refine_*`` knobs, and ``moe_dispatch`` /
    ``moe_capacity_factor`` (applied once at entry, as in the JAX package;
    both MoE dispatches).  ``hybrid`` calibration, ``rank_mode="adaptive"``
    and ``calib_mesh`` raise ``NotImplementedError`` naming the slice that
    brings them.

    ``scan_collect`` and ``refine_scan`` choose between the JAX package's
    ``lax.scan`` dispatch and its per-microbatch loop.  The port always runs
    the loop (eager PyTorch issues one forward per microbatch either way),
    so both are accepted and have no effect.
    """

    ratio: float = 0.8
    rank_mode: str = "uniform"
    rank_floor_ratio: float = 0.25
    rank_ceil_ratio: float = 0.0
    objective: str = "anchored"   # agnostic | input_aware | shift_aware | anchored
    refine: bool = True
    refine_epochs: int = 25
    refine_lr: float = 1e-4
    refine_weight_decay: float = 0.0
    refine_warmup_frac: float = 0.1
    refine_scan: Optional[bool] = None
    refine_target_mse: float = 0.0  # early-stop plateau (0 = off)
    remap: bool = False           # Dobi-style ratio accounting (App. B.4)
    eps: float = 1e-6
    whiten: str = "eigh"          # eigh | cholesky
    rank_multiple: int = 8
    microbatch: int = 8           # calibration sequences per forward
    calib_mode: str = "sequential"  # sequential | fused (hybrid: later)
    replay_taps: Any = ()
    drift_threshold: float = 0.25
    scan_collect: Optional[bool] = None
    calib_mesh: Any = None
    moe_dispatch: str = "inherit"
    moe_capacity_factor: Optional[float] = None
    debug_covs: bool = False      # snapshot per-tap covariances in the report
    verbose: bool = False         # INFO-level progress via logging


# ---------------------------------------------------------------------------
# linear-spec tables


class LinearSpec(NamedTuple):
    """One compressible linear: where its weight lives and which activation
    tap feeds its covariances."""

    path: str
    tap: str
    bank: bool = False


def linear_specs(kind: str, cfg) -> List[LinearSpec]:
    if kind not in B.FORWARD_KINDS:
        raise NotImplementedError(
            f"linear specs of kind {kind!r} are not ported to repro_torch "
            "yet (come with the slice of that architecture)")
    S_ = LinearSpec
    if kind.startswith("mla"):
        specs = [S_("attn.wq", "attn/qkv_in"),
                 S_("attn.wkv_a", "attn/qkv_in"),
                 S_("attn.wk_b", "attn/kvb_in"),
                 S_("attn.wv_b", "attn/kvb_in"),
                 S_("attn.wo", "attn/o_in")]
    else:
        specs = [S_("attn.wq", "attn/qkv_in"),
                 S_("attn.wk", "attn/qkv_in"),
                 S_("attn.wv", "attn/qkv_in"),
                 S_("attn.wo", "attn/o_in")]
    if kind.endswith("_moe"):
        specs += [S_("ffn.experts.gate", "ffn/experts_in", True),
                  S_("ffn.experts.up", "ffn/experts_in", True),
                  S_("ffn.experts.down", "ffn/experts_down_in", True)]
        if cfg.moe.num_shared_experts:
            specs += [S_("ffn.shared.gate", "ffn/shared/in"),
                      S_("ffn.shared.up", "ffn/shared/in"),
                      S_("ffn.shared.down", "ffn/shared/down_in")]
        return specs
    if cfg.act_fn == "silu":
        specs += [S_("ffn.gate", "ffn/in")]
    specs += [S_("ffn.up", "ffn/in"),
              S_("ffn.down", "ffn/down_in")]
    return specs


def tap_groups(specs) -> List[Tuple[str, List[LinearSpec]]]:
    """Group consecutive specs sharing a tap (shared covariances)."""
    groups: List[Tuple[str, List]] = []
    for spec in specs:
        if groups and groups[-1][0] == spec[1]:
            groups[-1][1].append(spec)
        else:
            groups.append((spec[1], [spec]))
    return groups


# ---------------------------------------------------------------------------
# param path utilities


def get_path(tree, path: str):
    for part in path.split("."):
        tree = tree[part]
    return tree


def set_path(tree, path: str, value):
    """Replace the entry at ``path`` in place (the containers, never the
    tensors: callers hand in freshly cloned containers)."""
    parts = path.split(".")
    node = tree
    for part in parts[:-1]:
        node = node[part]
    node[parts[-1]] = value
    return tree


# ---------------------------------------------------------------------------
# model unroll / restack


@dataclasses.dataclass
class Unit:
    name: str
    kind: str
    where: Tuple            # ("dec", stage_idx, iter_idx, kind_idx)
    params: Any


def _clone(tree):
    """Fresh containers around the same tensors."""
    return tree_map(lambda x: x, tree)


def unit_iterator(params, cfg):
    """Yield the model's compression units in solve order; a stacked stage's
    iteration ``it`` is sliced out (views, never written) when reached."""
    idx = 0
    for si, (st, sp) in enumerate(zip(B.stage_program(cfg),
                                      params["stages"])):
        iters = st.n if (st.scan and st.n > 1) else 1
        for it in range(iters):
            for ki, kind in enumerate(st.kinds):
                p = sp[ki]
                if iters > 1:
                    p = tree_map(lambda a: a[it], p)
                else:
                    p = _clone(p)
                yield Unit(name=f"dec.{idx}.{kind}", kind=kind,
                           where=("dec", si, it, ki), params=p)
                idx += 1


def restack_units(params, cfg, units: List[Unit]):
    """Write compressed unit params back (restacking stacked stages)."""
    new_params = dict(params)
    out = []
    for si, st in enumerate(B.stage_program(cfg)):
        per_kind = []
        for ki in range(len(st.kinds)):
            mine = sorted((u for u in units
                           if u.where[1] == si and u.where[3] == ki),
                          key=lambda u: u.where[2])
            if st.scan and st.n > 1:
                per_kind.append(tree_map(lambda *xs: torch.stack(xs),
                                         mine[0].params,
                                         *[u.params for u in mine[1:]]))
            else:
                per_kind.append(mine[0].params)
        out.append(per_kind)
    new_params["stages"] = out
    return new_params


# ---------------------------------------------------------------------------
# unit forward (optionally tapped)


def make_unit_apply(kind: str, cfg, seq_len: int, want_taps: bool):
    """fn(p, x, aux) -> y, or (y, {tap: activation}) with ``want_taps``."""

    def fn(p, x, aux):
        ctx = M.make_ctx(cfg, torch.arange(seq_len, device=x.device))
        if want_taps:
            store: Dict[str, torch.Tensor] = {}
            with L.sowing(store):
                y, _ = B.apply_sub_block(kind, p, x, cfg, ctx)
            return y, store
        y, _ = B.apply_sub_block(kind, p, x, cfg, ctx)
        return y

    return fn


# ---------------------------------------------------------------------------
# per-weight solve


def _solve_weight(w, covs, k: int, ccfg: CompressConfig):
    """Closed-form solve of one (n, m) weight, or of an (E, n, m) expert
    bank one expert at a time (the JAX package vmaps it) with the expert's
    own (E, n, n) covariances, all at the uniform rank k."""
    if ccfg.objective == "agnostic":
        def solve(wi, *_):
            return LR.solve_agnostic(wi, k)
        cov_ab = cov_bb = None
    else:
        cov_ab, cov_bb = C.objective_covs(covs, ccfg.objective)

        def solve(wi, ca, cb):
            return LR.solve_anchored(wi, ca, cb, k, eps=ccfg.eps,
                                     method=ccfg.whiten)
    if w.dim() == 2:
        return solve(w, cov_ab, cov_bb)
    per_expert = [solve(w[e], None if cov_ab is None else cov_ab[e],
                        None if cov_bb is None else cov_bb[e])
                  for e in range(w.shape[0])]
    return {key: torch.stack([f[key] for f in per_expert])
            for key in per_expert[0]}


def _weight_rank(w, ccfg: CompressConfig) -> int:
    n, m = (w.shape[-2], w.shape[-1])
    return R.rank_for_ratio(m, n, ccfg.ratio, remap=ccfg.remap,
                            multiple=ccfg.rank_multiple)


# ---------------------------------------------------------------------------
# driver


def _check_supported(cfg, ccfg: CompressConfig) -> None:
    if ccfg.calib_mode == "hybrid":
        raise NotImplementedError(
            "calib_mode='hybrid' is not ported to repro_torch yet (comes "
            "with the calibration-policies slice)")
    if ccfg.calib_mode not in ("sequential", "fused"):
        raise ValueError(f"unknown calib_mode {ccfg.calib_mode!r}")
    if ccfg.rank_mode == "adaptive":
        raise NotImplementedError(
            "rank_mode='adaptive' is not ported to repro_torch yet (comes "
            "with the calibration-policies slice)")
    if ccfg.rank_mode != "uniform":
        raise ValueError(f"unknown rank_mode {ccfg.rank_mode!r}")
    if ccfg.calib_mesh is not None:
        raise NotImplementedError(
            "calib_mesh is not ported to repro_torch yet (data-parallel "
            "collection comes with the torch.distributed slice)")
    if ccfg.moe_dispatch not in ("inherit", "capacity", "dropfree"):
        raise ValueError(f"unknown moe_dispatch {ccfg.moe_dispatch!r}")
    if (cfg.family, cfg.attention) not in (("dense", "full"),
                                           ("dense", "sliding_mix"),
                                           ("moe", "mla")):
        raise NotImplementedError(
            f"family {cfg.family!r} / attention {cfg.attention!r} is not "
            "ported to repro_torch yet (comes with that architecture's slice)")


def _effective_cfg(cfg, ccfg: CompressConfig):
    """The MoE routing overrides applied ONCE at entry, so every tapped
    forward, solve and the returned model agree on the dispatch (the JAX
    package's ``compress_model``, :801-812)."""
    if cfg.moe is not None and cfg.moe.num_experts and (
            ccfg.moe_dispatch != "inherit"
            or ccfg.moe_capacity_factor is not None):
        cfg = dataclasses.replace(cfg, moe=dataclasses.replace(
            cfg.moe,
            dispatch=(cfg.moe.dispatch if ccfg.moe_dispatch == "inherit"
                      else ccfg.moe_dispatch),
            capacity_factor=(cfg.moe.capacity_factor
                             if ccfg.moe_capacity_factor is None
                             else ccfg.moe_capacity_factor)))
    return cfg


def _drop_rate(cfg, fwd_taps, orig_p, x0, clock: "_StageClock") -> float:
    """Share of routed choices the unit drops on the first calibration
    microbatch: one tapped forward of the original stream, which the engine
    does not count (the JAX package's probe, :954-968).  The drop-free
    dispatch never drops: 0.0, with no forward."""
    if cfg.moe.dispatch == "dropfree":
        return 0.0
    with clock("collect"):
        _, probe = fwd_taps(orig_p, x0, None)
        dropped, total = probe["ffn/experts_dropped"].tolist()
    return dropped / max(total, 1.0)


def _embed_stream(params, cfg, calib: Dict[str, torch.Tensor], mb: int):
    """Initial hidden stream batches: a list of (mb, L, d)."""
    n = calib["tokens"].shape[0]
    return [M._embed_inputs(params, cfg,
                            {k: v[i: i + mb] for k, v in calib.items()})
            for i in range(0, n, mb)]


STAGES = ("embed", "collect", "solve", "refine", "propagate")


class _StageClock:
    """Adds the wall seconds of each driver stage into ``times`` (a dict
    keyed by ``STAGES``), synchronizing the device around every stage so a
    CUDA stage is charged its device work.  With ``times=None`` it neither
    synchronizes nor measures."""

    def __init__(self, times: Optional[Dict[str, float]], device):
        self.times = times
        self.device = device
        if times is not None:
            for stage in STAGES:
                times.setdefault(stage, 0.0)

    def _sync(self):
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    @contextlib.contextmanager
    def __call__(self, stage: str):
        if self.times is None:
            yield
            return
        self._sync()
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self._sync()
            self.times[stage] += time.perf_counter() - t0


def compress_model(params, cfg, calib: Dict[str, Any],
                   ccfg: CompressConfig, *, device=None,
                   stage_times: Optional[Dict[str, float]] = None):
    """Compress all blocks of a model (Algorithm 2).

    params: the port's param tree (torch tensors; moved to ``device``, never
    modified); cfg: ModelConfig; calib: {"tokens": (N, L)} as tensors or
    numpy arrays; device: None (the card) or e.g. "cpu".  ``stage_times``,
    when given a dict, receives the wall seconds spent in each of
    ``STAGES`` (the device is synchronized around each stage for that).
    Returns (compressed_params, report).  An MoE model compressed with
    ``moe_dispatch="dropfree"`` is evaluated with the same override
    (``cfg.moe.dispatch = "dropfree"``), as in the JAX package; the
    report's ``calibration.moe_drop_rate`` gives each MoE unit's share of
    routed choices dropped on the first calibration microbatch.
    """
    dev = resolve_device(device)
    cfg = _effective_cfg(cfg, ccfg)
    _check_supported(cfg, ccfg)
    params = tree_map(lambda t: t.to(dev), params)
    calib = {k: (v if torch.is_tensor(v) else torch.from_numpy(np.array(v)))
             .to(dev) for k, v in calib.items()}
    with torch.no_grad():
        new_params, report = _compress_sweep(
            params, cfg, calib, ccfg, _StageClock(stage_times, dev))
    return new_params, report


def _compress_sweep(params, cfg, calib, ccfg: CompressConfig,
                    clock: _StageClock):
    """One pass over the units (the uniform driver of the JAX package's
    ``_compress_sweep``, :848)."""
    params = _clone(params)
    report: Dict[str, Any] = {"units": [],
                              "config": dataclasses.asdict(ccfg)}
    mb = ccfg.microbatch
    with clock("embed"):
        xs = _embed_stream(params, cfg, calib, mb)      # original stream
        xps = [x.clone() for x in xs]                    # shifted stream
    done_units: List[Unit] = []

    for unit in unit_iterator(params, cfg):
        done_units.append(unit)
        seq_len = xs[0].shape[1]
        orig_p = _clone(unit.params)
        cur_p = unit.params
        fwd_taps = make_unit_apply(unit.kind, cfg, seq_len, want_taps=True)
        fwd = make_unit_apply(unit.kind, cfg, seq_len, want_taps=False)
        unit_report = {"name": unit.name, "kind": unit.kind,
                       "calib_mode": ccfg.calib_mode, "linears": []}
        if unit.kind.endswith("_moe"):
            unit_report["moe_drop_rate"] = _drop_rate(
                cfg, fwd_taps, orig_p, xs[0], clock)

        # ---- stage 1: streaming covariance accumulation + closed-form solve
        t_s1 = time.perf_counter()
        groups = tap_groups(linear_specs(unit.kind, cfg))
        engine: Optional[S.CalibrationEngine] = None
        anchors = None  # original-stream outputs captured by the fused pass
        if ccfg.objective != "agnostic":
            with clock("collect"):
                engine = S.CalibrationEngine.for_unit(
                    groups, fwd_taps, orig_p, xs[0], None,
                    num_experts=(cfg.moe.num_experts
                                 if unit.kind.endswith("_moe") else 0))
                if ccfg.calib_mode == "fused":
                    anchors = engine.collect_fused(fwd_taps, orig_p, cur_p,
                                                   xs, xps, None, None)
        drifts: Dict[str, float] = {}
        for tap, group in groups:
            covs = None
            if engine is not None:
                if ccfg.calib_mode == "sequential":
                    # both streams replayed for this group, so its shifted
                    # taps see every group solved so far
                    with clock("collect"):
                        engine.collect_group(tap, fwd_taps, orig_p, cur_p,
                                             xs, xps, None, None)
                drifts[tap] = engine.drift(tap)
                covs = engine.covs_for(tap)
                if ccfg.debug_covs:
                    unit_report.setdefault("covs", {})[tap] = {
                        k: (v.detach().cpu() if torch.is_tensor(v) else v)
                        for k, v in covs.items()}
            for spec in group:
                wp = get_path(cur_p, spec.path)
                w = wp["w"]
                k = _weight_rank(w, ccfg)
                with clock("solve"):
                    factors = _solve_weight(w, covs, k, ccfg)
                new_p = {kk: vv for kk, vv in wp.items() if kk != "w"}
                new_p.update(factors)
                set_path(cur_p, spec.path, new_p)
                entry = {"path": spec.path, "rank": k,
                         "shape": list(w.shape),
                         "ratio": R.achieved_ratio(w.shape[-1], w.shape[-2],
                                                   k, remap=ccfg.remap)}
                if tap in drifts:
                    entry["shift_drift"] = drifts[tap]
                unit_report["linears"].append(entry)
            if engine is not None:
                engine.release(tap)  # solved: free this group's covariances
            LOG.debug("%s: group %s -> rank %d", unit.name, tap,
                      unit_report["linears"][-1]["rank"])
        unit_report["tapped_forwards"] = \
            engine.stats["tapped_forwards"] if engine is not None else 0
        unit_report["replayed_groups"] = 0
        unit_report["replay_taps"] = []
        if xs[0].is_cuda:
            torch.cuda.synchronize(xs[0].device)
        unit_report["calib_wall"] = time.perf_counter() - t_s1
        if drifts:
            unit_report["shift_drift"] = drifts

        # ---- stage 2: block-level refinement --------------------------------
        if anchors is not None:  # the fused pass already ran the original
            y_anchor = list(anchors)
        else:
            with clock("propagate"):
                y_anchor = [fwd(orig_p, x, None) for x in xs]
        if ccfg.refine:
            t0 = time.perf_counter()
            with clock("refine"):
                cur_p, hist = RF.refine_unit(
                    fwd, cur_p, [(xp, None) for xp in xps], y_anchor,
                    epochs=ccfg.refine_epochs, lr=ccfg.refine_lr,
                    warmup_frac=ccfg.refine_warmup_frac,
                    weight_decay=ccfg.refine_weight_decay,
                    target_mse=ccfg.refine_target_mse)
            unit_report.update(pre_refine_mse=hist["pre_refine_mse"],
                               post_refine_mse=hist["post_refine_mse"],
                               refine_steps=hist["steps"],
                               refine_mode=hist["mode"],
                               refine_dispatches=hist["dispatches"],
                               refine_wall=time.perf_counter() - t0)
        else:
            mse = sum(float(torch.mean(torch.square(
                fwd(cur_p, xp, None).float() - y.float())))
                for xp, y in zip(xps, y_anchor)) / len(xps)
            unit_report["pre_refine_mse"] = mse

        # ---- propagate streams ------------------------------------------------
        with clock("propagate"):
            for i in range(len(xs)):
                xs[i] = y_anchor[i].to(xs[i].dtype)
                xps[i] = fwd(cur_p, xps[i], None)
        unit.params = cur_p
        report["units"].append(unit_report)
        msg = f"[compress] {unit.name}"
        if "post_refine_mse" in unit_report:
            msg += (f" mse {unit_report['pre_refine_mse']:.3e} -> "
                    f"{unit_report['post_refine_mse']:.3e}")
        LOG.log(logging.INFO if ccfg.verbose else logging.DEBUG, "%s", msg)

    report["calibration"] = {
        "mode": ccfg.calib_mode,
        "tapped_forwards": sum(u["tapped_forwards"] for u in report["units"]),
        "replayed_groups": 0,
        "calib_dp": 1,
        "rank_mode": {"mode": ccfg.rank_mode},
        # effective MoE routing after the CompressConfig overrides
        "moe_dispatch": (cfg.moe.dispatch if cfg.moe is not None
                         and cfg.moe.num_experts else None),
        "wall": sum(u.get("calib_wall", 0.0) for u in report["units"]),
    }
    drop_rates = {u["name"]: u["moe_drop_rate"] for u in report["units"]
                  if "moe_drop_rate" in u}
    if drop_rates:
        report["calibration"]["moe_drop_rate"] = drop_rates
    refined = [u for u in report["units"] if "refine_wall" in u]
    report["refinement"] = {
        # the port always refines in a per-step loop (no scanned schedule)
        "scan": False if ccfg.refine else None,
        "steps": sum(u["refine_steps"] for u in refined),
        "dispatches": sum(u["refine_dispatches"] for u in refined),
        "wall": sum(u["refine_wall"] for u in refined),
    }
    return restack_units(params, cfg, done_units), report


def compress_ratio_report(params, new_params) -> Dict[str, float]:
    def count(t):
        return sum(x.numel() for x in tree_leaves(t))
    before, after = count(params), count(new_params)
    return {"params_before": before, "params_after": after,
            "ratio": after / before}
