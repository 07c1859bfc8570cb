"""Algorithm 2: end-to-end block-wise AA-SVD compression with refinement.

Counterpart of ``src/repro/core/pipeline.py`` for ``rank_mode="uniform"``,
``calib_mode`` "fused" or "sequential", ``calib_mesh=None``.  The model is
unrolled into units (one transformer block each; stacked stages are sliced
and restacked afterwards).  Per unit:

  1. calibration statistics via the streaming engine (``core.streaming``):
     every tap group (q/k/v share a tap, gate/up share) owns a covariance
     triple {XᵀX, XᵀX', X'ᵀX'}, X from the ORIGINAL unit on the original
     stream and X' from the partially compressed unit on the shifted
     stream, accumulated by the ``cov_accum`` CUDA kernel.  Then solve
     Thm 3.2 per linear and swap the weight for its (U, V) factors.
  2. block-level refinement (``core.refine``) against the original outputs.
  3. propagate both streams: X ← L_i(X) with original weights,
     X' ← L'_i(X') with compressed weights (factorized linears run the
     ``lowrank_matmul`` CUDA kernel).

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

    Ported in this slice: ``rank_mode="uniform"``, ``calib_mode`` "fused"
    and "sequential", ``calib_mesh=None``, every objective, eigh and
    cholesky whitening, and the ``refine_*`` knobs.  ``hybrid`` calibration,
    ``rank_mode="adaptive"``, ``calib_mesh`` and the MoE routing overrides
    raise ``NotImplementedError`` naming the slice that brings them.

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
    if kind != "attn":
        raise NotImplementedError(
            f"linear specs of kind {kind!r} are not ported to repro_torch "
            "yet (come with the slice of that architecture)")
    S_ = LinearSpec
    specs = [S_("attn.wq", "attn/qkv_in"),
             S_("attn.wk", "attn/qkv_in"),
             S_("attn.wv", "attn/qkv_in"),
             S_("attn.wo", "attn/o_in")]
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
    if ccfg.objective == "agnostic":
        return LR.solve_agnostic(w, k)
    cov_ab, cov_bb = C.objective_covs(covs, ccfg.objective)
    return LR.solve_anchored(w, cov_ab, cov_bb, k, eps=ccfg.eps,
                             method=ccfg.whiten)


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
    if cfg.moe is not None and cfg.moe.num_experts:
        raise NotImplementedError(
            "MoE models are not ported to repro_torch yet (MoE slice)")
    if cfg.family != "dense" or cfg.attention != "full":
        raise NotImplementedError(
            f"family {cfg.family!r} / attention {cfg.attention!r} is not "
            "ported to repro_torch yet (comes with that architecture's slice)")


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
    Returns (compressed_params, report).
    """
    dev = resolve_device(device)
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

        # ---- stage 1: streaming covariance accumulation + closed-form solve
        t_s1 = time.perf_counter()
        groups = tap_groups(linear_specs(unit.kind, cfg))
        engine: Optional[S.CalibrationEngine] = None
        anchors = None  # original-stream outputs captured by the fused pass
        if ccfg.objective != "agnostic":
            with clock("collect"):
                engine = S.CalibrationEngine.for_unit(groups, fwd_taps,
                                                      orig_p, xs[0], None)
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
        "moe_dispatch": None,
        "wall": sum(u.get("calib_wall", 0.0) for u in report["units"]),
    }
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
