"""falcon-mamba-7b (Mamba1) and zamba2-7b (a Mamba2 backbone with one
weight-shared attention block) through the whole port against the JAX
package on the CPU.

Smoke configs in fp32: falcon-mamba 2 ``mamba1`` layers; zamba2 6 layers
as two scanned groups of 3 ``mamba2`` + ``shared_attn`` (and 7 layers,
whose remainder stage is one ``mamba2``, for the stage programs, unit
names and losses).  zamba2's shared block is one unit at its first site
(``dec.shared.shared_attn``), compressed there, and ``reused`` at its
second (``dec.7.shared_attn(shared-site)``): both streams only propagated,
zero forwards tapped.

The module shares one JAX and one port ``compress_model`` per (arch,
calibration mode), fused and sequential, from the same bridged params and
the same uniform numpy tokens (ratio 0.6, ``rank_multiple=1``, one refine
epoch, microbatch 2): 8 x 32 for falcon-mamba, 16 x 32 for zamba2, so
every tap covariance is well conditioned (n <= 128; ROADMAP hazard 3d).
Each unit solves on the stream the compressed units before it made, so the
packages' gap grows with depth: on zamba2 at 8 x 32 it rose from 4e-6
(unit 0) to 2.5e-3 (unit 6's ``out_proj``, condition 5.6e2) with the unit
MSEs equal, as gemma3's did in ``tests/test_torch_sliding.py``; at 16 x 32
the worst is 3.6e-4.  Held exactly:
ranks, unit names, kinds, ``reused``, ``tapped_forwards``,
``replayed_groups``, the param tree's containers (``None`` stage slots,
``params["shared"]``); to 1e-3 relative Frobenius: every composed map,
compared as it acts on the shifted stream the solve saw in sequential mode
(its later groups are collected after the earlier ones are solved, as in
``tests/test_torch_deepseek.py``); ppl to 0.5 %.  Adaptive ranks on
zamba2 (hybrid calibration, ``replay_taps="auto"``) equal the JAX
package's.  A format-3 checkpoint of the compressed zamba2 moves between
the packages bit for bit.  ``Server`` and the engine (latent and dense
caches, every request ``whole_exact``) give the JAX servers' tokens from
the JAX package's compressed params (its servers on an Auto-axis mesh,
ROADMAP hazard 3a).
"""

from __future__ import annotations

import torch_thread_cap  # noqa: F401  (thread caps under pytest-xdist)
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import AxisType

from repro.checkpoint.manager import CheckpointManager as JManager
from repro.configs import get_smoke_config as j_smoke
from repro.core import pipeline as JP
from repro.core.factorized import factorize_params as j_factorize
from repro.launch import serve as JS
from repro.models import blocks as JB
from repro.models import model as JM
from repro_torch import bridge
from repro_torch import configs as TC
from repro_torch.checkpoint import CheckpointManager
from repro_torch.checkpoint.manager import _flatten_with_paths
from repro_torch.core import pipeline as TP
from repro_torch.core.factorized import factorize_params
from repro_torch.launch import serve as TS
from repro_torch.models import blocks as TB
from repro_torch.models import model as TM

FALCON, ZAMBA = "falcon-mamba-7b", "zamba2-7b"
RECIPE = dict(ratio=0.6, rank_multiple=1, microbatch=2, refine_epochs=1,
              debug_covs=True)
CALIB = {FALCON: (8, 32), ZAMBA: (16, 32)}
MAP_TOL = 1e-3


def _cfgs(arch, **kw):
    return (j_smoke(arch).replace(dtype="float32", **kw),
            TC.get_smoke_config(arch).replace(dtype="float32", **kw))


def _auto_mesh():
    return jax.make_mesh((1, 1), ("data", "model"),
                         axis_types=(AxisType.Auto,) * 2)


def _dense(cfg, seed=0):
    return jax.tree.map(np.asarray, JM.init_params(cfg,
                                                   jax.random.PRNGKey(seed)))


def _batches(vocab, n=2, seed=4):
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        t = rng.integers(0, vocab, (4, 33)).astype(np.int32)
        out.append({"tokens": t[:, :-1], "labels": t[:, 1:]})
    return out


def _ppl(loss, params, cfg, batches, to):
    tot = sum(float(loss(params, cfg, {k: to(v) for k, v in b.items()})[0])
              for b in batches)
    return float(np.exp(tot / len(batches)))


def _structure(tree):
    """The containers of a param tree, leaves replaced by their shapes."""
    if isinstance(tree, dict):
        return {k: _structure(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return [_structure(v) for v in tree]
    if tree is None:
        return None
    return tuple(tree.shape)


# ---------------------------------------------------------------------------
# stage programs, units, loss


@pytest.mark.parametrize("arch,layers", [(FALCON, 2), (ZAMBA, 6),
                                         (ZAMBA, 7)])
def test_stage_programs_and_units_match_reference(arch, layers):
    jcfg, tcfg = _cfgs(arch, num_layers=layers)
    jprog, tprog = JB.stage_program(jcfg), TB.stage_program(tcfg)
    assert [(s.kinds, s.n, s.scan) for s in tprog] == \
        [(s.kinds, s.n, s.scan) for s in jprog]
    dense = _dense(jcfg)
    tparams = TM.init_params(tcfg, 0, device="cpu")
    assert _structure(tparams) == _structure(dense)
    junits = list(JP.unit_iterator(dense, jcfg))
    tunits = list(TP.unit_iterator(tparams, tcfg))
    assert [(u.name, u.kind, u.where, u.shared, u.params is None)
            for u in tunits] == \
        [(u.name, u.kind, u.where, u.shared, u.params is None)
         for u in junits]
    if arch == ZAMBA:
        names = [u.name for u in tunits]
        assert names.count("dec.shared.shared_attn") == 1
        assert "dec.7.shared_attn(shared-site)" in names
        assert names[-1] == ("dec.8.mamba2" if layers == 7
                             else "dec.7.shared_attn(shared-site)")
        # the stacked stages keep None where the shared kind sits
        assert all(st[-1] is None for st in tparams["stages"][:1])
        assert sorted(tparams["shared"]) == ["shared_attn"]


@pytest.mark.parametrize("arch,layers", [(FALCON, 2), (ZAMBA, 7)])
def test_loss_of_bridged_params_matches_reference(arch, layers):
    jcfg, tcfg = _cfgs(arch, num_layers=layers)
    dense = _dense(jcfg, seed=3)
    batches = _batches(jcfg.vocab_size)
    want = _ppl(JM.loss_fn, jax.tree.map(jnp.asarray, dense), jcfg, batches,
                jnp.asarray)
    with torch.no_grad():
        got = _ppl(TM.loss_fn, bridge.to_torch(dense), tcfg, batches,
                   torch.from_numpy)
    assert got == pytest.approx(want, rel=1e-5)


# ---------------------------------------------------------------------------
# compression


@functools.lru_cache(maxsize=None)
def _compressed(arch, mode):
    """One JAX and one port compression of ``arch``'s smoke config under
    calibration ``mode``, shared by the module's tests."""
    jcfg, tcfg = _cfgs(arch)
    dense = _dense(jcfg)
    toks = np.random.default_rng(0).integers(0, jcfg.vocab_size,
                                             CALIB[arch]).astype(np.int32)
    recipe = dict(RECIPE, calib_mode=mode)
    jc, jrep = JP.compress_model(jax.tree.map(jnp.asarray, dense), jcfg,
                                 {"tokens": jnp.asarray(toks)},
                                 JP.CompressConfig(**recipe))
    tparams = bridge.to_torch(dense)
    tc, trep = TP.compress_model(tparams, tcfg, {"tokens": toks},
                                 TP.CompressConfig(**recipe), device="cpu")
    return dict(arch=arch, mode=mode, jcfg=jcfg, tcfg=tcfg, dense=dense,
                tparams=tparams, jc=jax.tree.map(np.asarray, jc), jrep=jrep,
                tc=tc, trep=trep)


@pytest.fixture(scope="module", params=[(FALCON, "fused"),
                                        (FALCON, "sequential"),
                                        (ZAMBA, "fused"),
                                        (ZAMBA, "sequential")],
                ids=lambda p: f"{p[0]}-{p[1]}")
def run(request):
    return _compressed(*request.param)


def test_report_entries_and_ranks_match(run):
    jrep, trep = run["jrep"], run["trep"]
    assert [u["name"] for u in trep["units"]] == \
        [u["name"] for u in jrep["units"]]
    for ju, tu in zip(jrep["units"], trep["units"]):
        for key in ("kind", "calib_mode", "reused", "tapped_forwards",
                    "replayed_groups"):
            assert tu.get(key) == ju.get(key), (tu["name"], key)
        assert [(lin["path"], lin["rank"], lin["shape"])
                for lin in tu.get("linears", [])] == \
            [(lin["path"], lin["rank"], lin["shape"])
             for lin in ju.get("linears", [])]
        if ju.get("reused"):
            assert set(tu) == set(ju)
    for key in ("mode", "tapped_forwards", "replayed_groups"):
        assert trep["calibration"][key] == jrep["calibration"][key], key
    if run["arch"] == ZAMBA:
        reused = [u for u in trep["units"] if u.get("reused")]
        assert [u["name"] for u in reused] == \
            ["dec.7.shared_attn(shared-site)"]
        assert reused[0]["tapped_forwards"] == 0
        assert reused[0]["replayed_groups"] == 0
        assert reused[0]["calib_mode"] == run["mode"]


def test_param_tree_matches_reference(run):
    # None stage slots and the one compressed shared block, as the JAX
    # package lays them out; the caller's params are untouched
    assert _structure(run["tc"]) == _structure(run["jc"])
    if run["arch"] == ZAMBA:
        assert run["tc"]["stages"][0][-1] is None
        assert "u" in run["tc"]["shared"]["shared_attn"]["attn"]["wk"]
    before = bridge.to_torch(run["dense"])
    for (name, a), (_, b) in zip(_flatten_with_paths(run["tparams"]),
                                 _flatten_with_paths(before)):
        assert torch.equal(a, b), name


def _unit_maps(params, cfg):
    """[(unit name, kind, {path: composed map})] of every compressed unit
    (a weight-shared block once, at its first site), in solve order."""
    out = []
    for unit in TP.unit_iterator(params, cfg):
        if unit.params is None:
            continue
        maps = {}
        for spec in TP.linear_specs(unit.kind, cfg):
            lin = TP.get_path(unit.params, spec.path)
            maps[spec.path] = (lin["v"].double() @ lin["u"].double()).numpy()
        out.append((unit.name, unit.kind, maps))
    return out


def test_composed_maps_match(run):
    tcfg = run["tcfg"]
    want = _unit_maps(bridge.to_torch(run["jc"]), tcfg)
    got = _unit_maps(run["tc"], tcfg)
    assert [(n, k) for n, k, _ in got] == [(n, k) for n, k, _ in want]
    by_name = {u["name"]: u for u in run["trep"]["units"]}
    sequential = run["mode"] == "sequential"
    checked = 0
    for (name, kind, gmaps), (_, _, wmaps) in zip(got, want):
        unit = by_name[name]
        first_tap = TP.linear_specs(kind, tcfg)[0].tap
        for spec in TP.linear_specs(kind, tcfg):
            g, w = gmaps[spec.path], wmaps[spec.path]
            dw = g - w
            if sequential and spec.tap != first_tap:
                # collected after the unit's earlier groups were solved:
                # the map as it acts on that shifted stream
                cov = unit["covs"][spec.tap]["xpxp"].numpy().astype(
                    np.float64)
                lam, q = np.linalg.eigh(cov)
                half = q * np.sqrt(np.clip(lam, 0.0, None))
                err = (np.linalg.norm(half.T @ dw)
                       / np.linalg.norm(half.T @ w))
            else:
                err = np.linalg.norm(dw) / np.linalg.norm(w)
            assert err <= MAP_TOL, (name, spec.path, err)
            checked += 1
    assert checked == (8 if run["arch"] == FALCON else 6 * 2 + 7)


def test_ppl_matches_reference(run):
    batches = _batches(run["jcfg"].vocab_size)
    want = _ppl(JM.loss_fn, jax.tree.map(jnp.asarray, run["jc"]),
                run["jcfg"], batches, jnp.asarray)
    with torch.no_grad():
        got = _ppl(TM.loss_fn, run["tc"], run["tcfg"], batches,
                   torch.from_numpy)
    assert got == pytest.approx(want, rel=5e-3)


def test_refine_mse_matches_reference(run):
    for ju, tu in zip(run["jrep"]["units"], run["trep"]["units"]):
        for key in ("pre_refine_mse", "post_refine_mse"):
            if key in ju:
                assert tu[key] == pytest.approx(ju[key], rel=1e-3), \
                    (tu["name"], key)


@pytest.fixture(scope="module")
def adaptive():
    """zamba2 smoke under ``rank_mode="adaptive"`` with hybrid calibration
    and ``replay_taps="auto"``, in both packages."""
    jcfg, tcfg = _cfgs(ZAMBA)
    dense = _dense(jcfg)
    toks = np.random.default_rng(0).integers(0, jcfg.vocab_size,
                                             CALIB[ZAMBA]).astype(np.int32)
    recipe = dict(RECIPE, calib_mode="hybrid", replay_taps="auto",
                  rank_mode="adaptive", debug_covs=False)
    _, jrep = JP.compress_model(jax.tree.map(jnp.asarray, dense), jcfg,
                                {"tokens": jnp.asarray(toks)},
                                JP.CompressConfig(**recipe))
    _, trep = TP.compress_model(bridge.to_torch(dense), tcfg,
                                {"tokens": toks},
                                TP.CompressConfig(**recipe), device="cpu")
    return jrep, trep


def test_adaptive_ranks_match_reference(adaptive):
    jrep, trep = adaptive
    assert [u["name"] for u in trep["units"]] == \
        [u["name"] for u in jrep["units"]]
    for ju, tu in zip(jrep["units"], trep["units"]):
        assert [(lin["path"], lin["rank"], lin.get("uniform_rank"))
                for lin in tu.get("linears", [])] == \
            [(lin["path"], lin["rank"], lin.get("uniform_rank"))
             for lin in ju.get("linears", [])], tu["name"]
        for key in ("reused", "tapped_forwards", "replayed_groups",
                    "replay_taps"):
            assert tu.get(key) == ju.get(key), (tu["name"], key)
    ja, ta = (r["calibration"]["rank_mode"] for r in (jrep, trep))
    assert set(ta) == set(ja)
    for key, want in ja.items():
        if isinstance(want, float):
            assert ta[key] == pytest.approx(want, rel=1e-12), key
        else:
            assert ta[key] == want, key
    ranks = {lin["rank"] for u in trep["units"]
             for lin in u.get("linears", [])}
    assert len(ranks) > 1


def test_factorize_params_matches_reference_with_shared_block():
    jcfg, tcfg = _cfgs(ZAMBA, num_layers=7)
    want = jax.eval_shape(lambda: j_factorize(
        JM.init_params(jcfg, jax.random.PRNGKey(0)), jcfg, ratio=0.6))
    got = factorize_params(TM.init_params(tcfg, 0, device="cpu"), tcfg,
                           ratio=0.6, device="cpu")
    assert _structure(got) == _structure(want)
    shared = got["shared"]["shared_attn"]
    assert all("u" in shared["attn"][w] for w in ("wq", "wk", "wv", "wo"))
    assert all(st[ki] is None for st, prog in zip(got["stages"],
                                                  TB.stage_program(tcfg))
               for ki, kind in enumerate(prog.kinds)
               if kind == "shared_attn")


# ---------------------------------------------------------------------------
# checkpoints


def _bits(x):
    return (x.numpy().tobytes() if torch.is_tensor(x)
            else np.ascontiguousarray(x).tobytes())


def _assert_same(got, want):
    assert _structure(got) == _structure(want)
    fg, fw = _flatten_with_paths(got), _flatten_with_paths(want)
    assert [n for n, _ in fg] == [n for n, _ in fw]
    for (name, g), (_, w) in zip(fg, fw):
        assert (str(g.dtype).replace("torch.", "")
                == str(w.dtype).replace("torch.", "")), name
        assert _bits(g) == _bits(w), name


def test_checkpoint_moves_between_packages_bitwise(tmp_path):
    run = _compressed(ZAMBA, "fused")
    # the port writes, the JAX package reads: None slots and the shared
    # tree kept, every leaf's bits equal
    CheckpointManager(str(tmp_path / "t"), async_save=False).save(
        0, run["tc"], meta={"arch": ZAMBA})
    _, got, meta = JManager(str(tmp_path / "t"), async_save=False
                            ).restore_tree(0)
    assert meta == {"arch": ZAMBA}
    assert got["stages"][0][-1] is None
    _assert_same(got, bridge.to_numpy(run["tc"]))
    # the JAX package writes its own compression, the port reads it
    JManager(str(tmp_path / "j"), async_save=False).save(0, run["jc"])
    _, back, _ = CheckpointManager(str(tmp_path / "j")).restore_tree(
        0, device="cpu")
    assert back["stages"][0][-1] is None
    _assert_same(back, bridge.to_torch(run["jc"]))
    # from_checkpoint serves what the in-memory model serves
    prompts = np.random.default_rng(6).integers(
        0, run["tcfg"].vocab_size, (2, 9)).astype(np.int32)
    want = TS.Server(run["tcfg"], bridge.to_torch(run["jc"]), max_len=24,
                     batch=2, device="cpu").generate(prompts, steps=6)
    srv = TS.Server.from_checkpoint(run["tcfg"], str(tmp_path / "j"),
                                    max_len=24, batch=2, device="cpu")
    assert torch.equal(srv.generate(prompts, steps=6), want)


# ---------------------------------------------------------------------------
# serving


def _requests(module, vocab):
    rng = np.random.default_rng(3)
    return [module.Request(rid=i, prompt=rng.integers(
        0, vocab, (n,)).astype(np.int32), steps=s)
        for i, (n, s) in enumerate(zip((5, 13, 9, 2), (6, 4, 7, 5)))]


@pytest.mark.parametrize("arch", [FALCON, ZAMBA])
def test_serving_matches_reference(arch):
    # the JAX package's compressed weights (fused), bridged: Server (3
    # prompts of 10 tokens on 4 slots, 8 steps) and the engine (4 requests
    # on 2 slots, over the latent and the dense cache) give the JAX
    # servers' tokens
    run = _compressed(arch, "fused")
    jcfg, tcfg = run["jcfg"], run["tcfg"]
    jp, tp = jax.tree.map(jnp.asarray, run["jc"]), bridge.to_torch(run["jc"])
    prompts = np.random.default_rng(2).integers(
        0, jcfg.vocab_size, (3, 10)).astype(np.int32)
    want = JS.Server(jcfg, jp, max_len=32, batch=4, mesh=_auto_mesh()
                     ).generate(jnp.asarray(prompts), steps=8)
    got = TS.Server(tcfg, tp, max_len=32, batch=4, device="cpu"
                    ).generate(prompts, steps=8)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    for layout in ("auto", "dense"):
        cache = TM.init_cache(tcfg, 1, 8, params=(
            tp if layout == "auto" else None), device="cpu")
        kinds = [k for st in TB.stage_program(tcfg) for k in st.kinds]
        for kind, c in zip(kinds, cache[0]):
            want_keys = ({"h", "conv"} if kind.startswith("mamba")
                         else {"lk", "lv"} if layout == "auto"
                         else {"k", "v"})
            assert set(c) == want_keys, (kind, layout)
        jeng = JS.ContinuousBatchingServer(jcfg, jp, max_len=40, slots=2,
                                           cache_layout=layout,
                                           mesh=_auto_mesh())
        want = jeng.run(_requests(JS, jcfg.vocab_size))
        teng = TS.ContinuousBatchingServer(tcfg, tp, max_len=40, slots=2,
                                           prefill_chunk=8,
                                           cache_layout=layout,
                                           device="cpu")
        got = teng.run(_requests(TS, tcfg.vocab_size))
        assert sorted(got) == sorted(want)
        for rid in want:
            np.testing.assert_array_equal(got[rid]["tokens"],
                                          want[rid]["tokens"])
        assert set(teng.prefill_routes.values()) == {"whole_exact"}
        assert teng.prefill_routes == jeng.prefill_routes


@pytest.mark.parametrize("arch", [FALCON, ZAMBA])
def test_serve_cli_takes_the_arch(arch, capsys):
    toks = TS.main(["--arch", arch, "--smoke", "--ratio", "1.0",
                    "--engine", "--batch", "2", "--prompt-len", "6",
                    "--steps", "4", "--device", "cpu"])
    assert toks.shape == (2, 4)
    assert "generated (2, 4)" in capsys.readouterr().out
