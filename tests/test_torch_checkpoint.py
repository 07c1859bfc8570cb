"""Format-3 checkpoints of the port (``repro_torch.checkpoint``) against the
JAX package's ``repro.checkpoint``, ``factorize_params``, and serving from
a checkpoint.

* Round trips: fp32 and bf16 leaves bit-identical, leafless containers
  (``None``, ``{}``, tuples) kept, incomplete ``.tmp`` steps ignored,
  retention, async save, ``restore(step, like)``.
* Interop both ways, bit for bit: the port writes its adaptive llama smoke
  compression and the JAX package's ``restore_tree`` reads what
  ``bridge.to_numpy`` gives; the JAX package writes its own adaptive
  drop-free deepseek smoke compression (padded, and with
  ``reslice_banks=True``) and the port restores what ``bridge.to_torch``
  gives.  Manifests are equal field by field apart from ``created``,
  ``rank_per_expert`` included: the masked tails' ``-0.0`` entries read
  as live in both packages (ROADMAP hazard 3h).
* ``factorize_params`` gives the JAX package's names, shapes and dtypes on
  every arch the port registers.
* ``Server.from_checkpoint`` and ``ContinuousBatchingServer.from_checkpoint``
  give the JAX package's tokens from the same checkpoint (its servers on an
  Auto-axis mesh, ROADMAP hazard 3a); the serving CLI compresses
  adaptively, saves and serves back.
"""

from __future__ import annotations

import torch_thread_cap  # noqa: F401  (thread caps under pytest-xdist)
import os

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
from repro.models import model as JM
from repro_torch import bridge
from repro_torch import configs as TC
from repro_torch.checkpoint import CheckpointManager
from repro_torch.checkpoint.manager import _flatten_with_paths
from repro_torch.core import pipeline as TP
from repro_torch.core.factorized import factorize_params
from repro_torch.launch import serve as TS
from repro_torch.models import model as TM

LLAMA, DEEPSEEK = "llama-7b", "deepseek-v2-lite-16b"


def _auto_mesh():
    return jax.make_mesh((1, 1), ("data", "model"),
                         axis_types=(AxisType.Auto,) * 2)


def _bits(x):
    return (x.view(torch.int16).numpy().tobytes() if torch.is_tensor(x)
            and x.dtype == torch.bfloat16 else
            x.numpy().tobytes() if torch.is_tensor(x)
            else np.ascontiguousarray(x).tobytes())


def _assert_same(got, want):
    """Two trees (torch or numpy leaves) with the same containers, names,
    dtypes and bits."""
    assert jax.tree_util.tree_structure(
        jax.tree.map(lambda _: 0, got, is_leaf=torch.is_tensor)) == \
        jax.tree_util.tree_structure(
            jax.tree.map(lambda _: 0, want, is_leaf=torch.is_tensor))
    fg, fw = _flatten_with_paths(got), _flatten_with_paths(want)
    assert [n for n, _ in fg] == [n for n, _ in fw]
    for (name, g), (_, w) in zip(fg, fw):
        gd = str(g.dtype).replace("torch.", "")
        assert gd == str(w.dtype).replace("torch.", ""), name
        assert tuple(g.shape) == tuple(w.shape), name
        assert _bits(g) == _bits(w), name


def _manifests_equal(a, b):
    a, b = dict(a), dict(b)
    a.pop("created"), b.pop("created")
    la = {e["name"]: e for e in a.pop("leaves")}
    lb = {e["name"]: e for e in b.pop("leaves")}
    assert a == b
    assert la == lb


def _tree():
    g = torch.Generator().manual_seed(0)
    return {"w": torch.randn(3, 4, generator=g),
            "half": torch.randn(5, generator=g).to(torch.bfloat16),
            "stages": [[{"a": torch.randn(2, 2, generator=g)}, None], []],
            "empty": {}, "pair": (torch.arange(3), None),
            "ids": torch.tensor([1, 2], dtype=torch.int32)}


# ---------------------------------------------------------------------------
# round trips


def test_round_trip_bitwise_with_leafless_containers(tmp_path):
    tree = _tree()
    mgr = CheckpointManager(str(tmp_path), async_save=False)
    mgr.save(3, tree, meta={"note": "x"})
    step, got, meta = mgr.restore_tree(device="cpu")
    assert step == 3 and meta == {"note": "x"}
    _assert_same(got, tree)
    assert got["stages"][0][1] is None and got["stages"][1] == []
    assert got["empty"] == {} and isinstance(got["pair"], tuple)
    # restore into a template: its leaves name the entries, values unused
    like = jax.tree.map(torch.zeros_like, tree, is_leaf=torch.is_tensor)
    step, got = mgr.restore(None, like, device="cpu")
    _assert_same(got, tree)


def test_incomplete_tmp_ignored_and_retention(tmp_path):
    mgr = CheckpointManager(str(tmp_path), keep=2, async_save=False)
    for s in range(4):
        mgr.save(s, {"x": torch.full((2,), float(s))})
    assert mgr.all_steps() == [2, 3]
    os.makedirs(tmp_path / "step_000000009.tmp")
    (tmp_path / "step_000000009.tmp" / "leaf_00000.npy").write_bytes(b"x")
    assert mgr.latest_step() == 3
    _, tree, _ = mgr.restore_tree(device="cpu")
    assert torch.equal(tree["x"], torch.full((2,), 3.0))
    # a restored step is never collected
    mgr.restore_tree(2, device="cpu")
    mgr.save(4, {"x": torch.zeros(2)})
    mgr.save(5, {"x": torch.zeros(2)})
    assert 2 in mgr.all_steps() and mgr.all_steps()[-2:] == [4, 5]


def test_async_save_snapshots_at_call(tmp_path):
    mgr = CheckpointManager(str(tmp_path), async_save=True)
    x = torch.ones(1000)
    mgr.save(0, {"x": x})
    x.zero_()                      # the host copy was taken by save()
    mgr.save(1, {"x": x})
    mgr.wait()
    assert mgr.all_steps() == [0, 1]
    assert torch.equal(mgr.restore_tree(0, device="cpu")[1]["x"],
                       torch.ones(1000))
    assert torch.equal(mgr.restore_tree(1, device="cpu")[1]["x"],
                       torch.zeros(1000))


def test_restore_defaults_to_the_card(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("this machine has CUDA: the default device is valid")
    mgr = CheckpointManager(str(tmp_path), async_save=False)
    mgr.save(0, {"x": torch.ones(2)})
    with pytest.raises(RuntimeError, match="CUDA"):
        mgr.restore_tree()


# ---------------------------------------------------------------------------
# interop with the JAX package


@pytest.fixture(scope="module")
def port_llama():
    """The port's adaptive hybrid compression of llama smoke (fp32)."""
    tcfg = TC.get_smoke_config(LLAMA).replace(dtype="float32")
    params = TM.init_params(tcfg, 0, device="cpu")
    toks = np.random.default_rng(0).integers(0, tcfg.vocab_size, (8, 32))
    comp, rep = TP.compress_model(
        params, tcfg, {"tokens": toks},
        TP.CompressConfig(ratio=0.6, microbatch=2, refine_epochs=1,
                          calib_mode="hybrid", replay_taps="auto",
                          rank_mode="adaptive"), device="cpu")
    return tcfg, comp, rep


def test_port_writes_jax_reads(tmp_path, port_llama):
    _, comp, _ = port_llama
    CheckpointManager(str(tmp_path / "t"), async_save=False).save(
        0, comp, meta={"by": "port"})
    jm = JManager(str(tmp_path / "t"), async_save=False)
    _, got, meta = jm.restore_tree(0)
    assert meta == {"by": "port"}
    _assert_same(got, bridge.to_numpy(comp))
    # the JAX package writing the same tree writes the same manifest
    JManager(str(tmp_path / "j"), async_save=False).save(
        0, bridge.to_numpy(comp), meta={"by": "port"})
    _manifests_equal(jm.manifest(0),
                     JManager(str(tmp_path / "j")).manifest(0))


def test_bf16_interop(tmp_path):
    tree = _tree()
    CheckpointManager(str(tmp_path / "t"), async_save=False).save(0, tree)
    _, got, _ = JManager(str(tmp_path / "t"), async_save=False
                         ).restore_tree(0)
    assert str(got["half"].dtype) == "bfloat16"
    _assert_same(got, bridge.to_numpy(tree))
    JManager(str(tmp_path / "j"), async_save=False).save(
        0, bridge.to_numpy(tree))
    _, back, _ = CheckpointManager(str(tmp_path / "j")).restore_tree(
        0, device="cpu")
    _assert_same(back, tree)


@pytest.fixture(scope="module")
def jax_deepseek():
    """The JAX package's adaptive compression of deepseek smoke under the
    drop-free dispatch: per-expert ranks, padded banks with masked tails."""
    cfg = j_smoke(DEEPSEEK).replace(dtype="float32", num_layers=2)
    params = JM.init_params(cfg, jax.random.PRNGKey(0))
    toks = np.random.default_rng(0).integers(0, cfg.vocab_size, (16, 64),
                                             dtype=np.int32)
    comp, rep = JP.compress_model(
        params, cfg, {"tokens": jnp.asarray(toks)},
        JP.CompressConfig(ratio=0.6, microbatch=2, refine=False,
                          calib_mode="fused", rank_mode="adaptive",
                          moe_dispatch="dropfree", rank_multiple=1))
    return jax.tree.map(np.asarray, comp), rep


@pytest.mark.parametrize("reslice", [False, True])
def test_jax_writes_port_reads(tmp_path, jax_deepseek, reslice):
    comp, rep = jax_deepseek
    ranks = [lin["rank_per_expert"] for u in rep["units"]
             for lin in u["linears"] if "rank_per_expert" in lin]
    assert ranks and any(len(set(r)) > 1 for r in ranks)
    jm = JManager(str(tmp_path / "j"), async_save=False)
    jm.save(0, comp, reslice_banks=reslice)
    mgr = CheckpointManager(str(tmp_path / "j"), async_save=False)
    _, got, _ = mgr.restore_tree(0, device="cpu")
    _assert_same(got, bridge.to_torch(comp))
    # the port writing what it restored writes the JAX package's manifest:
    # every bank's rank_per_expert reads kmax (its masked tails hold -0.0)
    CheckpointManager(str(tmp_path / "t"), async_save=False).save(
        0, got, reslice_banks=reslice)
    jman = jm.manifest(0)
    _manifests_equal(CheckpointManager(str(tmp_path / "t")).manifest(0),
                     jman)
    banks = [e for e in jman["leaves"] if "rank_per_expert" in e]
    assert len(banks) == 6
    for e in banks:
        kmax = e["shape"][-1 if e["name"].endswith("/v") else -2]
        assert e["rank_per_expert"] == [kmax] * e["shape"][0], e["name"]


def test_port_masked_banks_write_the_reference_manifest(tmp_path):
    """The port's own adaptive drop-free banks: tails masked by
    multiplication, so the manifest it writes equals the one the JAX
    package writes for the same tree."""
    tcfg = TC.get_smoke_config(DEEPSEEK).replace(dtype="float32",
                                                 num_layers=2)
    params = TM.init_params(tcfg, 0, device="cpu")
    toks = np.random.default_rng(0).integers(0, tcfg.vocab_size, (16, 64))
    comp, _ = TP.compress_model(
        params, tcfg, {"tokens": toks},
        TP.CompressConfig(ratio=0.6, microbatch=2, refine=False,
                          calib_mode="fused", rank_mode="adaptive",
                          moe_dispatch="dropfree", rank_multiple=1),
        device="cpu")
    for reslice in (False, True):
        t_dir, j_dir = tmp_path / f"t{reslice}", tmp_path / f"j{reslice}"
        CheckpointManager(str(t_dir), async_save=False).save(
            0, comp, reslice_banks=reslice)
        JManager(str(j_dir), async_save=False).save(
            0, bridge.to_numpy(comp), reslice_banks=reslice)
        _manifests_equal(CheckpointManager(str(t_dir)).manifest(0),
                         JManager(str(j_dir)).manifest(0))
        _, back, _ = JManager(str(t_dir)).restore_tree(0)
        _assert_same(back, bridge.to_numpy(comp))


# ---------------------------------------------------------------------------
# factorize_params


@pytest.mark.parametrize("arch", sorted(TC._REGISTRY))
def test_factorize_params_matches_reference(arch):
    tcfg = TC.get_smoke_config(arch).replace(dtype="float32")
    cfg = j_smoke(arch).replace(dtype="float32")
    want = jax.eval_shape(lambda: j_factorize(
        JM.init_params(cfg, jax.random.PRNGKey(0)), cfg, ratio=0.6))
    params = TM.init_params(tcfg, 0, device="cpu")
    got = factorize_params(params, tcfg, ratio=0.6, device="cpu")
    meta = factorize_params(params, tcfg, ratio=0.6, device="meta")
    names = [n for n, _ in _flatten_with_paths(got)]
    flat_want = {"/".join(str(getattr(k, "key", f"[{getattr(k, 'idx', k)}]"))
                          for k in path): leaf
                 for path, leaf in jax.tree_util.tree_flatten_with_path(
                     want)[0]}
    assert sorted(names) == sorted(flat_want)
    n_factors = 0
    for (name, leaf), (_, m) in zip(_flatten_with_paths(got),
                                    _flatten_with_paths(meta)):
        w = flat_want[name]
        assert tuple(leaf.shape) == tuple(w.shape) == tuple(m.shape), name
        assert str(leaf.dtype).replace("torch.", "") == str(w.dtype), name
        if name.endswith(("/u", "/v")):
            assert not leaf.any() and m.is_meta, name
            n_factors += 1
    assert n_factors > 0
    assert factorize_params(params, tcfg, ratio=1.0) is params


# ---------------------------------------------------------------------------
# serving from a checkpoint


def test_from_checkpoint_serves_the_reference_tokens(tmp_path, port_llama):
    tcfg, comp, rep = port_llama
    ks = {lin["path"]: lin["rank"] for lin in rep["units"][0]["linears"]}
    assert ks["attn.wk"] != ks["attn.wv"] or len(set(ks.values())) > 1
    d = str(tmp_path)
    CheckpointManager(d, async_save=False).save(0, comp, meta={"r": 0.6})
    cfg = j_smoke(LLAMA).replace(dtype="float32")
    prompts = np.random.default_rng(5).integers(0, cfg.vocab_size, (3, 12),
                                                dtype=np.int32)
    jsrv = JS.Server.from_checkpoint(cfg, d, max_len=32, batch=4,
                                     mesh=_auto_mesh())
    tsrv = TS.Server.from_checkpoint(tcfg, d, max_len=32, batch=4,
                                     device="cpu")
    assert tsrv.checkpoint_meta == jsrv.checkpoint_meta == {"r": 0.6}
    want = np.asarray(jsrv.generate(jnp.asarray(prompts), steps=6))
    np.testing.assert_array_equal(tsrv.generate(prompts, steps=6).numpy(),
                                  want)
    np.testing.assert_array_equal(
        TS.Server(tcfg, comp, max_len=32, batch=4, device="cpu"
                  ).generate(prompts, steps=6).numpy(), want)
    lens, steps = (5, 12, 9), (6, 4, 7)
    jeng = JS.ContinuousBatchingServer.from_checkpoint(
        cfg, d, max_len=32, slots=2, prefill_chunk=4, mesh=_auto_mesh())
    teng = TS.ContinuousBatchingServer.from_checkpoint(
        tcfg, d, max_len=32, slots=2, prefill_chunk=4, device="cpu")
    assert teng.checkpoint_meta == {"r": 0.6}
    jres = jeng.run([JS.Request(rid=i, prompt=prompts[i, :n], steps=s)
                     for i, (n, s) in enumerate(zip(lens, steps))])
    tres = teng.run([TS.Request(rid=i, prompt=prompts[i, :n], steps=s)
                     for i, (n, s) in enumerate(zip(lens, steps))])
    for i in range(3):
        np.testing.assert_array_equal(tres[i]["tokens"], jres[i]["tokens"])


def test_serve_cli_adaptive_checkpoint(tmp_path, capsys):
    argv = ["--arch", LLAMA, "--smoke", "--ratio", "0.6", "--batch", "2",
            "--prompt-len", "8", "--steps", "4", "--device", "cpu",
            "--calib-mode", "auto", "--rank-mode", "adaptive",
            "--replay-taps", "auto", "--checkpoint", str(tmp_path)]
    toks = TS.main(argv + ["--engine"])
    out = capsys.readouterr().out
    assert "calib hybrid" in out and "ranks adaptive" in out, out
    assert toks.shape == (2, 4)
    assert CheckpointManager(str(tmp_path)).all_steps() == [0]
    np.testing.assert_array_equal(TS.main(argv), toks)
