"""Algorithm 2: end-to-end block-wise AA-SVD compression with refinement.

Counterpart of ``src/repro/core/pipeline.py`` with ``calib_mesh=None``, on
dense GQA models (llama, qwen3, granite, phi3-medium; gemma3's
sliding-window local and global layers), on deepseek's MLA + MoE, on
kimi-k2's GQA + MoE (capacity or drop-free dispatch), on falcon-mamba's
Mamba1 blocks, on zamba2's Mamba2 backbone with its weight-shared
attention block, and on the multimodal archs: phi-3-vision (calibration
``patches`` spliced before the tokens) and whisper (an encoder over
calibration ``frames``, then decoder units whose cross-attention reads the
encoder's output).  The model is unrolled into units (one block each;
stacked stages are sliced and restacked afterwards), the encoder's
(``enc.*``) before the decoder's (``dec.*``).  Whisper's encoder units
propagate two encoder streams, original and shifted, from the frames;
when the first decoder unit arrives both are normed by the encoder's final
norm once, and each decoder unit's original stream attends to the
original encoder output and its shifted stream to the shifted one (the
unit apply's ``aux``).  A weight-shared
block is one unit at its first site (``<section>.shared.<kind>``),
compressed there; at every later site it is only propagated, both streams
through its original and compressed params, and reported ``reused``.  Per
unit:

  1. calibration statistics via the streaming engine (``core.streaming``):
     every tap group (q/k/v share a tap, gate/up share) owns a covariance
     triple {XᵀX, XᵀX', X'ᵀX'}, X from the ORIGINAL unit on the original
     stream and X' from the partially compressed unit on the shifted
     stream, accumulated by the ``cov_accum`` CUDA kernel (per expert for
     the MoE's bank taps: one banked launch over the capacity buffers, or
     one launch an expert segment of the drop-free dispatch's rows).  Then
     solve Thm 3.2 per linear (per expert for a bank) and swap the weight
     for its (U, V) factors.
  2. block-level refinement (``core.refine``) against the original outputs.
  3. propagate both streams: X ← L_i(X) with original weights,
     X' ← L'_i(X') with compressed weights (factorized linears run the
     ``lowrank_matmul`` CUDA kernel; expert banks batched products under
     the capacity dispatch, ``grouped_matmul`` under the drop-free one).

``CompressConfig.calib_mode`` selects the collection policy, as in the JAX
package:

  * ``"sequential"`` — both streams replayed for every tap group, so later
    groups calibrate against the already-compressed earlier ones (2·G·B
    tapped forwards a unit for G groups and B microbatches);
  * ``"fused"`` — one tapped forward a microbatch a stream feeds every
    group (2·B); shifted taps see the unit pre-solve;
  * ``"hybrid"`` — one fused pass for every group except the *replay*
    groups (expert banks, specs flagged ``replay=True``, taps listed in
    ``replay_taps``), each re-collected sequentially at its solve turn
    (2·B + 2·R·B for R replay groups).  ``replay_taps="auto"`` fuses every
    group and replays those whose shift drift passes ``drift_threshold``.

``CompressConfig.rank_mode="adaptive"`` runs two sweeps: an ESTIMATE sweep
(the collection policy at uniform ranks, no refinement) that reads each
linear's truncation-loss estimate off its solve's own SVD and keeps every
covariance triple, ``ranks.allocate_by_loss`` water-filling the global
budget, then a SOLVE sweep that re-solves from the kept triples at the
allocated ranks (zero tapped forwards) and refines.  Under the drop-free
dispatch every expert is its own item: the bank is solved once at its
largest rank and each expert's factor tail masked (``_mask_expert_tails``).

``compress_model`` runs on the card unless the caller passes
``device="cpu"``, where the kernels' plain versions run instead.  The
caller's params are never modified.
"""

from __future__ import annotations

import contextlib
import dataclasses
import logging
import time
from typing import (Any, Dict, List, NamedTuple, Optional, Sequence,
                    Set, Tuple)

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

    Ported: both ``rank_mode`` values (``"adaptive"``: the two sweeps of the
    module docstring, ``rank_floor_ratio`` / ``rank_ceil_ratio`` the
    allocator's trust region), every ``calib_mode`` (``"hybrid"`` with a
    static ``replay_taps`` tuple or ``"auto"`` and ``drift_threshold``),
    every objective, eigh and cholesky whitening, the ``refine_*`` knobs,
    and ``moe_dispatch`` / ``moe_capacity_factor`` (applied once at entry,
    as in the JAX package; both MoE dispatches).  ``calib_mesh`` raises
    ``NotImplementedError``: data-parallel collection comes with the
    ``torch.distributed`` slice.

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
    calib_mode: str = "sequential"  # sequential | fused | hybrid
    replay_taps: Any = ()         # hybrid: extra tap names, or "auto"
    drift_threshold: float = 0.25  # replay_taps="auto": replay past this
    scan_collect: Optional[bool] = None
    calib_mesh: Any = None
    moe_dispatch: str = "inherit"
    moe_capacity_factor: Optional[float] = None
    debug_covs: bool = False      # snapshot per-tap covariances in the report
    verbose: bool = False         # INFO-level progress via logging


# ---------------------------------------------------------------------------
# linear-spec tables


class LinearSpec(NamedTuple):
    """One compressible linear: where its weight lives, which activation
    tap feeds its covariances, and whether hybrid calibration replays its
    tap group sequentially (``replay=True``: the expert banks)."""

    path: str
    tap: str
    bank: bool = False
    replay: bool = False


def linear_specs(kind: str, cfg) -> List[LinearSpec]:
    if kind not in B.FORWARD_KINDS:
        raise NotImplementedError(
            f"linear specs of kind {kind!r} are not ported to repro_torch "
            "yet (come with the slice of that architecture)")
    S_ = LinearSpec
    if kind == "mamba1":
        return [S_("mixer.in_proj", "mixer/in_proj_in"),
                S_("mixer.x_proj", "mixer/x_proj_in"),
                S_("mixer.dt_proj", "mixer/dt_proj_in"),
                S_("mixer.out_proj", "mixer/out_proj_in")]
    if kind == "mamba2":
        return [S_("mixer.in_proj", "mixer/in_proj_in"),
                S_("mixer.out_proj", "mixer/out_proj_in")]
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
    if kind == "dec_attn":
        specs += [S_("xattn.wq", "xattn/q_in"),
                  S_("xattn.wk", "xattn/kv_in"),
                  S_("xattn.wv", "xattn/kv_in"),
                  S_("xattn.wo", "xattn/o_in")]
    if kind.endswith("_moe"):
        specs += [S_("ffn.experts.gate", "ffn/experts_in", True, True),
                  S_("ffn.experts.up", "ffn/experts_in", True, True),
                  S_("ffn.experts.down", "ffn/experts_down_in", True, True)]
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


def replay_taps_for(groups, ccfg: "CompressConfig") -> Set[str]:
    """Taps whose groups hybrid mode re-collects sequentially: expert banks,
    specs flagged ``replay=True``, and the tap names of a
    ``replay_taps`` tuple.  ``replay_taps="auto"`` contributes no taps here
    (the driver flags groups by measured drift instead) and never
    substring-matches a tap name."""
    extra = () if isinstance(ccfg.replay_taps, str) else ccfg.replay_taps
    out: Set[str] = set()
    for tap, group in groups:
        if tap in extra or any(s.bank or s.replay for s in group):
            out.add(tap)
    return out


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
    where: Tuple            # ("enc"|"dec", stage_idx, iter_idx, kind_idx)
    params: Any             # None at a weight-shared block's later sites
    shared: bool = False


def _clone(tree):
    """Fresh containers around the same tensors."""
    return tree_map(lambda x: x, tree)


def unit_iterator(params, cfg):
    """Yield the model's compression units in solve order: the encoder's
    (``enc.<idx>.<kind>``, whisper) first, then the decoder's; a stacked
    stage's iteration ``it`` is sliced out (views, never written) when
    reached.  A weight-shared kind yields ``dec.shared.<kind>`` with the
    shared params at its first site and ``dec.<idx>.<kind>(shared-site)``
    with ``params=None`` at every later one."""
    seen_shared: Set[str] = set()

    def walk(section: str, stages, stage_params):
        idx = 0
        for si, (st, sp) in enumerate(zip(stages, stage_params)):
            iters = st.n if (st.scan and st.n > 1) else 1
            for it in range(iters):
                for ki, kind in enumerate(st.kinds):
                    where = (section, si, it, ki)
                    if kind in B.SHARED_KINDS:
                        if kind not in seen_shared:
                            seen_shared.add(kind)
                            yield Unit(name=f"{section}.shared.{kind}",
                                       kind=kind, where=where,
                                       params=_clone(
                                           params["shared"][kind]),
                                       shared=True)
                        else:
                            yield Unit(
                                name=f"{section}.{idx}.{kind}(shared-site)",
                                kind=kind, where=where, params=None,
                                shared=True)
                        idx += 1
                        continue
                    p = sp[ki]
                    if iters > 1:
                        p = tree_map(lambda a, it=it: a[it], p)
                    else:
                        p = _clone(p)
                    yield Unit(name=f"{section}.{idx}.{kind}", kind=kind,
                               where=where, params=p)
                    idx += 1

    if "encoder" in params:
        yield from walk("enc", B.encoder_stages(cfg),
                        params["encoder"]["stages"])
    yield from walk("dec", B.stage_program(cfg), params["stages"])


def restack_units(params, cfg, units: List[Unit]):
    """Write compressed unit params back (restacking stacked stages), the
    encoder's into ``params["encoder"]["stages"]``; a weight-shared kind
    keeps ``None`` in its stage slots and its compressed params go to
    ``params["shared"]``."""
    new_params = dict(params)

    def rebuild(section: str, stages):
        out = []
        for si, st in enumerate(stages):
            per_kind = []
            for ki, kind in enumerate(st.kinds):
                if kind in B.SHARED_KINDS:
                    per_kind.append(None)
                    continue
                mine = sorted((u for u in units
                               if u.where[:2] == (section, si)
                               and u.where[3] == ki),
                              key=lambda u: u.where[2])
                if st.scan and st.n > 1:
                    per_kind.append(tree_map(lambda *xs: torch.stack(xs),
                                             mine[0].params,
                                             *[u.params for u in mine[1:]]))
                else:
                    per_kind.append(mine[0].params)
            out.append(per_kind)
        return out

    if "encoder" in params:
        new_params["encoder"] = dict(params["encoder"])
        new_params["encoder"]["stages"] = rebuild("enc",
                                                  B.encoder_stages(cfg))
    new_params["stages"] = rebuild("dec", B.stage_program(cfg))
    shared = {u.kind: u.params for u in units
              if u.shared and u.params is not None}
    if shared:
        new_params["shared"] = shared
    return new_params


# ---------------------------------------------------------------------------
# unit forward (optionally tapped)


def make_unit_apply(kind: str, cfg, seq_len: int, want_taps: bool):
    """fn(p, x, aux) -> y, or (y, {tap: activation}) with ``want_taps``.
    ``aux`` is the encoder's output a whisper decoder unit attends to (the
    stream's own: original or shifted), else None."""

    def fn(p, x, aux):
        ctx = M.make_ctx(cfg, torch.arange(seq_len, device=x.device))
        if aux is not None:
            ctx["enc_out"] = aux
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


def _solve_weight(w, covs, k: int, ccfg: CompressConfig, *,
                  want_spectrum: bool = False):
    """Closed-form solve of one (n, m) weight, or of an (E, n, m) expert
    bank one expert at a time (the JAX package vmaps it) with the expert's
    own (E, n, n) covariances, at rank k.  ``want_spectrum=True`` (the
    adaptive estimate sweep) also returns the full singular spectrum of the
    solved matrix from the SAME whitening and SVD, stacked (E, s) for a
    bank."""
    if ccfg.objective == "agnostic":
        def solve(wi, *_):
            return (LR.solve_agnostic_with_spectrum(wi, k) if want_spectrum
                    else LR.solve_agnostic(wi, k))
        cov_ab = cov_bb = None
    else:
        cov_ab, cov_bb = C.objective_covs(covs, ccfg.objective)
        fn = (LR.solve_anchored_with_spectrum if want_spectrum
              else LR.solve_anchored)

        def solve(wi, ca, cb):
            return fn(wi, ca, cb, k, eps=ccfg.eps, method=ccfg.whiten)
    if w.dim() == 2:
        return solve(w, cov_ab, cov_bb)
    per_expert = [solve(w[e], None if cov_ab is None else cov_ab[e],
                        None if cov_bb is None else cov_bb[e])
                  for e in range(w.shape[0])]

    def stack(factors):
        return {key: torch.stack([f[key] for f in factors])
                for key in factors[0]}

    if want_spectrum:
        factors, spectra = zip(*per_expert)
        return stack(factors), torch.stack(spectra)
    return stack(per_expert)


def _weight_rank(w, ccfg: CompressConfig) -> int:
    n, m = (w.shape[-2], w.shape[-1])
    return R.rank_for_ratio(m, n, ccfg.ratio, remap=ccfg.remap,
                            multiple=ccfg.rank_multiple)


# ---------------------------------------------------------------------------
# adaptive rank allocation (rank_mode="adaptive")


def _estimate_items(unit: Unit, spec: LinearSpec, w, spectrum,
                    k_uniform: int, *,
                    per_expert: bool = False) -> List[Dict[str, Any]]:
    """Allocator inputs of one linear (the JAX package's, :558-620): the
    RELATIVE tail energy Σ_{j>k} σ_j² / Σ σ_j² of its solve's spectrum at
    the uniform rank, weighted by the linear's dense parameter count.  An
    expert bank is one pooled item (copies=E, one rank a bank), except
    under ``per_expert`` (drop-free dispatch), where every expert is its
    own item with its own tail.  Iterations of one stacked stage share a
    ``tie`` (one stacked factor buffer, one rank)."""
    section, si, _, ki = unit.where
    spectrum = spectrum.detach().float().cpu().numpy()
    base = {"unit": unit.name, "path": spec.path, "tap": spec.tap,
            "shape": (w.shape[-1], w.shape[-2]),
            "uniform_rank": k_uniform}
    if per_expert and w.dim() == 3:
        items = []
        for e in range(w.shape[0]):
            tail = LR.spectrum_tail_energy(spectrum[e], k_uniform)
            total = LR.spectrum_tail_energy(spectrum[e], 0)
            items.append(dict(
                base, copies=1, expert=e,
                tie=(section, si, ki, spec.path, e),
                loss=(tail / max(total, 1e-30)) * int(w[e].numel())))
        return items
    tail = LR.spectrum_tail_energy(spectrum, k_uniform)
    total = LR.spectrum_tail_energy(spectrum, 0)
    return [dict(
        base, copies=w.shape[0] if w.dim() == 3 else 1,
        tie=(section, si, ki, spec.path),
        loss=(tail / max(total, 1e-30)) * int(w.numel()))]


def _lambda_gap(keys, shapes, losses, ranks,
                ccfg: CompressConfig) -> Dict[str, Any]:
    """The allocation's margin against near-ties: the smallest relative gap
    between the water level λ at which an item reached its final rank (a
    step the fill took; items still at their floor took none) and the λ of
    another item's next lattice step (one it did not take), with the two
    items' keys.  λ is the allocator's own (ratio at the rank / loss^½); a
    gap of the order of the losses' rounding means two backends may
    allocate differently."""
    weights = [max(float(l), 1e-12) ** 0.5 for l in losses]
    taken, nexts = [], []
    for i, ((m, n), k) in enumerate(zip(shapes, ranks)):
        kmax = R.rank_cap(m, n, remap=ccfg.remap)
        floor = R._lattice_floor(
            R._real_rank(m, n, ccfg.rank_floor_ratio * ccfg.ratio,
                         remap=ccfg.remap), kmax, ccfg.rank_multiple)
        if k > floor:
            taken.append((R.achieved_ratio(m, n, k, remap=ccfg.remap)
                          / weights[i], i))
        nk = R._lattice_next(k, kmax, ccfg.rank_multiple)
        if nk is not None:
            nexts.append((R.achieved_ratio(m, n, nk, remap=ccfg.remap)
                          / weights[i], i))
    best = {"rel_gap": None, "taken": None, "next": None}
    for lt, i in taken:
        for ln, j in nexts:
            gap = abs(lt - ln) / max(lt, ln)
            if i != j and (best["rel_gap"] is None or gap < best["rel_gap"]):
                best = {"rel_gap": gap, "taken": keys[i], "next": keys[j]}
    return best


def _allocate_ranks(est: Dict[str, Any], ccfg: CompressConfig):
    """Global water-filling over every compressed linear: one parameter
    budget (ratio × the compressible linears' dense parameters),
    budget-exact to one lane multiple (``ranks.allocate_by_loss``).
    Returns ({(unit, path): rank, or a tuple of per-expert ranks}, the
    ``calibration.rank_mode`` summary), as the JAX package's (:623-671)."""
    items = est["items"]
    ties: Dict[Tuple, Dict[str, Any]] = {}
    for it in items:
        t = ties.get(it["tie"])
        if t is None:
            ties[it["tie"]] = {"shape": it["shape"], "loss": it["loss"],
                               "copies": it["copies"]}
        else:
            t["loss"] += it["loss"]
            t["copies"] += it["copies"]
    keys = list(ties)
    shapes = [ties[k]["shape"] for k in keys]
    losses = [ties[k]["loss"] for k in keys]
    ranks = R.allocate_by_loss(
        shapes, losses, ccfg.ratio, remap=ccfg.remap,
        multiple=ccfg.rank_multiple, floor_ratio=ccfg.rank_floor_ratio,
        ceil_ratio=ccfg.rank_ceil_ratio,
        copies=[ties[k]["copies"] for k in keys])
    gap = _lambda_gap(keys, shapes, losses, ranks, ccfg)
    LOG.log(logging.INFO if ccfg.verbose else logging.DEBUG,
            "adaptive allocation: %d rank groups, smallest relative "
            "lambda gap %s (%s taken, %s next)", len(keys), gap["rel_gap"],
            gap["taken"], gap["next"], extra={"lambda_gap": gap})
    by_tie = dict(zip(keys, ranks))
    # per-expert items (drop-free banks) share one (unit, path) key: their
    # entry is the TUPLE of per-expert ranks in expert order
    table: Dict[Tuple[str, str], Any] = {}
    per_exp: Dict[Tuple[str, str], Dict[int, int]] = {}
    key_shape: Dict[Tuple[str, str], Tuple[int, int]] = {}
    for it in items:
        key = (it["unit"], it["path"])
        key_shape[key] = it["shape"]
        if "expert" in it:
            per_exp.setdefault(key, {})[it["expert"]] = by_tie[it["tie"]]
        else:
            table[key] = by_tie[it["tie"]]
    for key, by_e in per_exp.items():
        table[key] = tuple(by_e[e] for e in range(len(by_e)))
    dense = sum(it["copies"] * it["shape"][0] * it["shape"][1]
                for it in items)
    stored = sum(it["copies"] * R.rank_cost(*it["shape"], remap=ccfg.remap)
                 * by_tie[it["tie"]] for it in items)
    # a per-expert bank keeps its stacked buffers at the max allocated rank
    # (masked tails): report the budget (logical) and stored (padded) sizes
    padded = stored
    for key, ks in ((k, v) for k, v in table.items()
                    if isinstance(v, tuple)):
        logical, pad = R.bank_padded_cost(*key_shape[key], ks,
                                          remap=ccfg.remap)
        padded += pad - logical
    alloc = {"mode": "adaptive", "target_ratio": ccfg.ratio,
             "achieved_ratio": stored / dense,
             "budget_params": int(ccfg.ratio * dense),
             "allocated_params": stored, "padded_params": padded,
             "linears": len(items),
             "rank_groups": len(keys),
             "min_rank": min(ranks), "max_rank": max(ranks)}
    return table, alloc


def _mask_expert_tails(factors: Dict[str, torch.Tensor],
                       ks: Sequence[int]) -> Dict[str, torch.Tensor]:
    """Zero each expert's factor components beyond its allocated rank.

    ``factors`` come from ONE bank solve at kmax = max(ks): v (E, n, kmax),
    u (E, kmax, m), σ-descending, so zeroing column j of v and row j of u
    removes exactly the rank-j component.  The mask MULTIPLIES, as the JAX
    package's does, so a negative entry of a masked tail becomes -0.0: the
    bits (and the checkpoint manifest's ``rank_per_expert``, which counts
    bitwise-zero slices) match the reference's."""
    kmax = factors["u"].shape[-2]
    dev = factors["u"].device
    keep = (torch.arange(kmax, device=dev)[None, :]
            < torch.tensor(ks, dtype=torch.int32, device=dev)[:, None])
    return {"v": factors["v"] * keep[:, None, :].to(factors["v"].dtype),
            "u": factors["u"] * keep[:, :, None].to(factors["u"].dtype)}


def _merge_adaptive_report(report, rep1, est: Dict[str, Any],
                           alloc: Dict[str, Any]) -> None:
    """Fold the estimate sweep's measurements into the solve sweep's
    report: its tapped forwards (all collection happened there), replay
    accounting, drift and per-linear loss estimates (the JAX package's,
    :690-723).  The solve sweep itself issued zero tapped forwards."""
    by_key = {(it["unit"], it["path"]): it for it in est["items"]}
    for u2, u1 in zip(report["units"], rep1["units"]):
        u2["tapped_forwards"] = u1["tapped_forwards"]
        for field in ("replayed_groups", "replay_taps", "shift_drift",
                      "moe_drop_rate"):
            if field in u1:
                u2[field] = u1[field]
        drift_by_path = {lin["path"]: lin["shift_drift"]
                         for lin in u1.get("linears", [])
                         if "shift_drift" in lin}
        for lin in u2.get("linears", []):
            item = by_key.get((u2["name"], lin["path"]))
            if item is not None:
                lin["trunc_loss_est"] = item["loss"]
                lin["uniform_rank"] = item["uniform_rank"]
            if lin["path"] in drift_by_path:
                lin["shift_drift"] = drift_by_path[lin["path"]]
    for field in ("tapped_forwards", "replayed_groups"):
        report["calibration"][field] = rep1["calibration"][field]
    if "moe_drop_rate" in rep1["calibration"]:
        report["calibration"]["moe_drop_rate"] = \
            rep1["calibration"]["moe_drop_rate"]
    report["calibration"]["rank_mode"] = dict(
        alloc, estimate_forwards=rep1["calibration"]["tapped_forwards"])


# ---------------------------------------------------------------------------
# driver


def _check_supported(cfg, ccfg: CompressConfig) -> None:
    """The JAX package's validation (:786-795): unknown mode strings raise
    ``ValueError``; ``calib_mesh`` and unported archs raise
    ``NotImplementedError``."""
    if ccfg.calib_mode not in ("sequential", "fused", "hybrid"):
        raise ValueError(f"unknown calib_mode {ccfg.calib_mode!r}")
    if ccfg.rank_mode not in ("uniform", "adaptive"):
        raise ValueError(f"unknown rank_mode {ccfg.rank_mode!r} "
                         "(expected 'uniform' or 'adaptive')")
    if isinstance(ccfg.replay_taps, str) and ccfg.replay_taps != "auto":
        raise ValueError(f"unknown replay_taps {ccfg.replay_taps!r} "
                         "(expected a tuple of tap names or 'auto')")
    if ccfg.moe_dispatch not in ("inherit", "capacity", "dropfree"):
        raise ValueError(f"unknown moe_dispatch {ccfg.moe_dispatch!r}")
    if ccfg.calib_mesh is not None:
        raise NotImplementedError(
            "calib_mesh is not ported to repro_torch yet (data-parallel "
            "collection comes with the torch.distributed slice)")
    if (cfg.family, cfg.attention) not in (("dense", "full"),
                                           ("dense", "sliding_mix"),
                                           ("moe", "mla"), ("moe", "full"),
                                           ("ssm", "none"),
                                           ("hybrid", "full"),
                                           ("encdec", "full"),
                                           ("vlm", "full")):
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


def _drop_rate(cfg, fwd_taps, orig_p, x0, aux0,
               clock: "_StageClock") -> float:
    """Share of routed choices the unit drops on the first calibration
    microbatch: one tapped forward of the original stream, which the engine
    does not count (the JAX package's probe, :954-968).  The drop-free
    dispatch never drops: 0.0, with no forward."""
    if cfg.moe.dispatch == "dropfree":
        return 0.0
    with clock("collect"):
        _, probe = fwd_taps(orig_p, x0, aux0)
        dropped, total = probe["ffn/experts_dropped"].tolist()
    return dropped / max(total, 1.0)


def _embed_stream(params, cfg, calib: Dict[str, torch.Tensor], mb: int):
    """Initial hidden stream batches: a list of (mb, L, d) (a vision
    model's patches spliced before the tokens; whisper's tokens with their
    sinusoid positions)."""
    n = calib["tokens"].shape[0]
    xs = []
    for i in range(0, n, mb):
        x = M._embed_inputs(params, cfg,
                            {k: v[i: i + mb] for k, v in calib.items()})
        if cfg.family == "encdec":
            x = M._with_positions(cfg, x, torch.arange(x.shape[1],
                                                       device=x.device))
        xs.append(x)
    return xs


def _encoder_stream(cfg, calib: Dict[str, torch.Tensor], mb: int):
    """Whisper's encoder input batches: the calibration frames with their
    sinusoid positions, a list of (mb, Le, d) in the activation dtype."""
    dtype = M.torch_dtype(cfg.dtype)
    frames = calib["frames"]
    le = frames.shape[1]
    positions = torch.arange(le, device=frames.device)
    return [M._with_positions(cfg, frames[i: i + mb].to(dtype), positions)
            for i in range(0, calib["tokens"].shape[0], mb)]


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
    ``STAGES`` (the device is synchronized around each stage for that);
    under ``rank_mode="adaptive"`` those are summed over both sweeps and
    ``"estimate.<stage>"`` holds the estimate sweep's share.
    Returns (compressed_params, report).  An MoE model compressed with
    ``moe_dispatch="dropfree"`` is evaluated with the same override
    (``cfg.moe.dispatch = "dropfree"``), as in the JAX package; the
    report's ``calibration.moe_drop_rate`` gives each MoE unit's share of
    routed choices dropped on the first calibration microbatch.
    """
    dev = resolve_device(device)
    _check_supported(cfg, ccfg)
    cfg = _effective_cfg(cfg, ccfg)
    params = tree_map(lambda t: t.to(dev), params)
    calib = {k: (v if torch.is_tensor(v) else torch.from_numpy(np.array(v)))
             .to(dev) for k, v in calib.items()}
    with torch.no_grad():
        if ccfg.rank_mode == "adaptive":
            # estimate sweep: the collection policy at uniform ranks, no
            # refinement; keeps every covariance triple
            est_times = None if stage_times is None else {}
            _, rep1, est = _compress_sweep(
                params, cfg, calib, ccfg, _StageClock(est_times, dev),
                estimate=True)
            rank_table, alloc = _allocate_ranks(est, ccfg)
            # solve sweep: re-solve from the kept triples at the allocated
            # ranks (zero tapped forwards), refinement at the final ranks
            new_params, report, _ = _compress_sweep(
                params, cfg, calib, ccfg, _StageClock(stage_times, dev),
                rank_table=rank_table, covs_table=est["covs"])
            _merge_adaptive_report(report, rep1, est, alloc)
            if stage_times is not None:
                for stage, t in est_times.items():
                    stage_times[stage] += t
                    stage_times[f"estimate.{stage}"] = t
            return new_params, report
        new_params, report, _ = _compress_sweep(
            params, cfg, calib, ccfg, _StageClock(stage_times, dev))
    return new_params, report


def _compress_sweep(params, cfg, calib, ccfg: CompressConfig,
                    clock: _StageClock, *, estimate: bool = False,
                    rank_table: Optional[Dict[Tuple[str, str], Any]] = None,
                    covs_table: Optional[Dict[str, Dict]] = None):
    """One pass over the units (the JAX package's ``_compress_sweep``,
    :848).  The default call is the uniform driver.

    ``estimate`` (adaptive sweep 1): solve at uniform ranks, skip
    refinement and the MSE probe, record each linear's allocator items and
    keep every covariance triple (returned in the estimate record).
    ``rank_table`` ((unit name, path) → rank or per-expert rank tuple,
    sweep 2) overrides the uniform ranks; ``covs_table`` (unit name → tap →
    triple, sweep 2) replaces collection: no engine, no tapped forwards, no
    drop-rate probe, and each triple is freed at its unit's solve turn.
    Returns (params, report, estimate record or None)."""
    params = _clone(params)
    report: Dict[str, Any] = {"units": [],
                              "config": dataclasses.asdict(ccfg)}
    est: Optional[Dict[str, Any]] = None
    if estimate:
        est = {"items": [], "covs": {}}
    auto_replay = (ccfg.calib_mode == "hybrid"
                   and isinstance(ccfg.replay_taps, str))
    mb = ccfg.microbatch
    encdec = cfg.family == "encdec"
    with clock("embed"):
        dec_o = _embed_stream(params, cfg, calib, mb)   # original stream
        dec_c = [x.clone() for x in dec_o]               # shifted stream
        # whisper: the encoder's streams run first; their normed outputs
        # feed the decoder units' cross-attention
        enc_o = _encoder_stream(cfg, calib, mb) if encdec else None
        enc_c = [x.clone() for x in enc_o] if encdec else None
    streams = {"enc": (enc_o, enc_c), "dec": (dec_o, dec_c)}
    enc_normed = False
    done_units: List[Unit] = []
    # weight-shared kind -> its original and compressed params, from the
    # first site
    shared_done: Dict[str, Dict[str, Any]] = {}

    for unit in unit_iterator(params, cfg):
        done_units.append(unit)
        section = unit.where[0]
        if section == "dec" and encdec and not enc_normed:
            # the decoder's cross-attention reads the NORMED encoder output
            norm = params["encoder"]["final_norm"]
            with clock("propagate"):
                for i in range(len(enc_o)):
                    enc_o[i] = L.apply_norm(norm, enc_o[i], eps=cfg.norm_eps)
                    enc_c[i] = L.apply_norm(norm, enc_c[i], eps=cfg.norm_eps)
            enc_normed = True
        xs, xps = streams[section]
        # the encoder output each stream's decoder units attend to
        aux_o, aux_c = ((enc_o, enc_c) if section == "dec" and encdec
                        else (None, None))

        def ao(i):
            return None if aux_o is None else aux_o[i]

        def ac(i):
            return None if aux_c is None else aux_c[i]

        seq_len = xs[0].shape[1]
        if unit.shared and unit.params is None:
            # a later site of a weight-shared block: only propagate both
            # streams.  The entry carries a compressed unit's accounting
            # keys (zero forwards tapped), so the totals need no special
            # case
            fwd = make_unit_apply(unit.kind, cfg, seq_len, want_taps=False)
            with clock("propagate"):
                for i in range(len(xs)):
                    xs[i] = fwd(shared_done[unit.kind]["orig"], xs[i], ao(i))
                    xps[i] = fwd(shared_done[unit.kind]["comp"], xps[i],
                                 ac(i))
            report["units"].append({"name": unit.name, "kind": unit.kind,
                                    "calib_mode": ccfg.calib_mode,
                                    "reused": True, "tapped_forwards": 0,
                                    "replayed_groups": 0})
            continue
        orig_p = _clone(unit.params)
        cur_p = unit.params
        fwd_taps = make_unit_apply(unit.kind, cfg, seq_len, want_taps=True)
        fwd = make_unit_apply(unit.kind, cfg, seq_len, want_taps=False)
        unit_report = {"name": unit.name, "kind": unit.kind,
                       "calib_mode": ccfg.calib_mode, "linears": []}
        if unit.kind.endswith("_moe") and covs_table is None:
            unit_report["moe_drop_rate"] = _drop_rate(
                cfg, fwd_taps, orig_p, xs[0], ao(0), clock)

        # ---- stage 1: streaming covariance accumulation + closed-form solve
        t_s1 = time.perf_counter()
        groups = tap_groups(linear_specs(unit.kind, cfg))
        replays: Set[str] = set()
        if ccfg.calib_mode == "hybrid" and not auto_replay:
            replays = replay_taps_for(groups, ccfg)
        engine: Optional[S.CalibrationEngine] = None
        anchors = None  # original-stream outputs captured by the fused pass
        if ccfg.objective != "agnostic" and covs_table is None:
            with clock("collect"):
                engine = S.CalibrationEngine.for_unit(
                    groups, fwd_taps, orig_p, xs[0], ao(0),
                    num_experts=(cfg.moe.num_experts
                                 if unit.kind.endswith("_moe") else 0))
                if ccfg.calib_mode in ("fused", "hybrid"):
                    # hybrid: every non-replay group and the anchors (with
                    # replay_taps="auto" the skip set is empty: the drift
                    # measured below decides)
                    anchors = engine.collect_fused(fwd_taps, orig_p, cur_p,
                                                   xs, xps, aux_o, aux_c,
                                                   skip=replays)
        replayed: List[str] = []
        drifts: Dict[str, float] = {}
        for tap, group in groups:
            covs = None
            drift: Optional[float] = None
            if engine is not None and auto_replay:
                # past the threshold the fused statistics are discarded and
                # the group replays sequentially
                drift = engine.drift(tap)
                if drift > ccfg.drift_threshold:
                    engine.reset(tap)
                    replays.add(tap)
            if engine is not None and (ccfg.calib_mode == "sequential"
                                       or tap in replays):
                # both streams replayed for this group, so its shifted
                # taps see every group solved so far
                with clock("collect"):
                    engine.collect_group(tap, fwd_taps, orig_p, cur_p,
                                         xs, xps, aux_o, aux_c)
                if tap in replays:
                    replayed.append(tap)
            if engine is not None:
                if drift is None:
                    drift = engine.drift(tap)
                drifts[tap] = drift
                covs = engine.covs_for(tap)
            elif covs_table is not None and ccfg.objective != "agnostic":
                # strict lookup: a (unit, tap) the estimate sweep did not
                # keep fails loudly
                covs = covs_table[unit.name][tap]
            if ccfg.debug_covs and covs is not None:
                unit_report.setdefault("covs", {})[tap] = {
                    # repro-check: allow[host-sync-loop] — debug_covs (off by default) copies each tap's covariances into the report on request
                    k: (v.detach().cpu() if torch.is_tensor(v) else v)
                    for k, v in covs.items()}
            for spec in group:
                wp = get_path(cur_p, spec.path)
                w = wp["w"]
                k = _weight_rank(w, ccfg)
                if rank_table is not None:
                    k = rank_table[(unit.name, spec.path)]
                with clock("solve"):
                    if est is not None:
                        # one decomposition serves both: the solve's own
                        # SVD gives the spectrum the loss estimate reads.
                        # Drop-free banks estimate per expert (the
                        # dispatch is batch-size invariant)
                        per_expert = (spec.bank and w.dim() == 3
                                      and cfg.moe is not None
                                      and cfg.moe.dispatch == "dropfree")
                        factors, spectrum = _solve_weight(
                            w, covs, k, ccfg, want_spectrum=True)
                        est["items"].extend(_estimate_items(
                            unit, spec, w, spectrum, k,
                            per_expert=per_expert))
                    elif isinstance(k, tuple):
                        # per-expert ranks: one bank solve at the max, each
                        # expert's factor tail masked (nested truncation)
                        factors = _mask_expert_tails(
                            _solve_weight(w, covs, max(k), ccfg), k)
                    else:
                        factors = _solve_weight(w, covs, k, ccfg)
                new_p = {kk: vv for kk, vv in wp.items() if kk != "w"}
                new_p.update(factors)
                set_path(cur_p, spec.path, new_p)
                if isinstance(k, tuple):
                    logical, pad = R.bank_padded_cost(
                        w.shape[-1], w.shape[-2], k, remap=ccfg.remap)
                    entry = {"path": spec.path, "rank": max(k),
                             "rank_per_expert": list(k),
                             "shape": list(w.shape),
                             "ratio": logical / int(w.numel()),
                             "padded_ratio": pad / int(w.numel())}
                else:
                    entry = {"path": spec.path, "rank": k,
                             "shape": list(w.shape),
                             "ratio": R.achieved_ratio(
                                 w.shape[-1], w.shape[-2], k,
                                 remap=ccfg.remap)}
                if drift is not None:
                    entry["shift_drift"] = drift
                unit_report["linears"].append(entry)
            if engine is not None and est is None:
                engine.release(tap)  # solved: free this group's covariances
            if covs_table is not None:
                # a kept triple is read only at its unit's solve turn: free
                # it there, so peak memory tracks the unsolved remainder
                covs_table[unit.name].pop(tap, None)
            LOG.debug("%s: group %s -> rank %d", unit.name, tap,
                      unit_report["linears"][-1]["rank"])
        if est is not None:
            # keep the triples: the solve sweep re-solves from exactly these
            est["covs"][unit.name] = (
                {tap: engine.covs_for(tap) for tap, _ in groups}
                if engine is not None else {})
        unit_report["tapped_forwards"] = \
            engine.stats["tapped_forwards"] if engine is not None else 0
        unit_report["replayed_groups"] = len(replayed)
        unit_report["replay_taps"] = replayed
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
                y_anchor = [fwd(orig_p, x, ao(i)) for i, x in enumerate(xs)]
        if ccfg.refine and not estimate:
            t0 = time.perf_counter()
            with clock("refine"):
                cur_p, hist = RF.refine_unit(
                    fwd, cur_p, [(xp, ac(i)) for i, xp in enumerate(xps)],
                    y_anchor,
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
        elif not estimate:  # the estimate sweep skips the MSE probe too
            # repro-check: allow[host-sync-loop] — the report's pre_refine_mse with refinement off: one read a microbatch of a unit, summed on the host (a device sum would change its bits)
            mse = sum(float(torch.mean(torch.square(
                fwd(cur_p, xp, ac(i)).float() - y.float())))
                for i, (xp, y) in enumerate(zip(xps, y_anchor))) / len(xps)
            unit_report["pre_refine_mse"] = mse

        # ---- propagate streams ------------------------------------------------
        with clock("propagate"):
            for i in range(len(xs)):
                xs[i] = y_anchor[i].to(xs[i].dtype)
                xps[i] = fwd(cur_p, xps[i], ac(i))
        unit.params = cur_p
        if unit.shared:
            shared_done[unit.kind] = {"orig": orig_p, "comp": cur_p}
        report["units"].append(unit_report)
        msg = f"[compress] {unit.name}"
        if "post_refine_mse" in unit_report:
            msg += (f" mse {unit_report['pre_refine_mse']:.3e} -> "
                    f"{unit_report['post_refine_mse']:.3e}")
        LOG.log(logging.INFO if ccfg.verbose else logging.DEBUG, "%s", msg)

    report["calibration"] = {
        "mode": ccfg.calib_mode,
        "tapped_forwards": sum(u["tapped_forwards"] for u in report["units"]),
        "replayed_groups": sum(u["replayed_groups"]
                               for u in report["units"]),
        "calib_dp": 1,
        # adaptive runs overwrite this with the allocation summary
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
    return restack_units(params, cfg, done_units), report, est


def compress_ratio_report(params, new_params) -> Dict[str, float]:
    def count(t):
        return sum(x.numel() for x in tree_leaves(t))
    before, after = count(params), count(new_params)
    return {"params_before": before, "params_after": after,
            "ratio": after / before}
