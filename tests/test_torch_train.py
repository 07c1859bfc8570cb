"""The port's trainer against the JAX package: train step, schedule, remat,
gradient compression, the training driver and its checkpoints.

Every registered arch's smoke config (fp32) runs three steps of
``repro.launch.steps.make_train_step(cfg, None)`` (jitted) and of the
port's ``make_train_step`` from bridged ``init_params`` on the same
numpy-made batches.  Limits: losses rel 1e-5 (measured ≤ 3.1e-7),
step-1 grads per leaf rel Frobenius 1e-4 (≤ 4.6e-6), params after step 3
per leaf rel Frobenius 3e-5, wider than 1e-5 because the reference forms
Adam's bias corrections 1 − β^t in fp32, 1.3–2.0e-5 off at t ≤ 3 (every
update's size moves by up to 1e-5: 7–9e-6 on whisper's zero-init biases
and zamba2's A_log), and a gradient entry at rounding level can flip the
sign of its first normalized update (deepseek smoke's dense-first
ffn/down: 1.19e-5).
"""

from __future__ import annotations

import torch_thread_cap  # noqa: F401  (thread caps under pytest-xdist)
import functools
import os
import pathlib
import re
import shutil
import signal
import subprocess
import sys
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint import CheckpointManager as JCheckpointManager
from repro.core import zoo
from repro.launch import steps as JS
from repro.models import model as JM
from repro.optim import adamw as JA
from repro.optim import compression as JCMP
from repro_torch import bridge
from repro_torch import configs as TC
from repro_torch.checkpoint import CheckpointManager
from repro_torch.checkpoint.manager import _flatten_with_paths
from repro_torch.data import make_batch_iterator
from repro_torch.launch import steps as TS
from repro_torch.launch import train as TT
from repro_torch.models import blocks as TB
from repro_torch.models import model as TM
from repro_torch.optim import adamw as TA
from repro_torch.optim import compression as TCMP
from repro_torch.tree import tree_leaves, tree_map

ROOT = pathlib.Path(__file__).resolve().parents[1]
ARCHS = list(TC.ALL_ARCHS)
SMOKE = "qwen3-0.6b"


def _batch(cfg, rng, b=2, seq=16):
    """A numpy LM batch, with the reference's frontend inputs: patches
    before the tokens and labels over both (zeros under the patches), or
    encoder frames."""
    toks = rng.integers(0, cfg.vocab_size, size=(b, seq + 1), dtype=np.int32)
    out = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
    if cfg.frontend == "vision":
        out["patches"] = (0.02 * rng.standard_normal(
            (b, cfg.num_patches, cfg.d_model))).astype(np.float32)
        out["labels"] = np.concatenate(
            [np.zeros((b, cfg.num_patches), np.int32), out["labels"]], 1)
    if cfg.frontend == "audio":
        out["frames"] = (0.02 * rng.standard_normal(
            (b, cfg.encoder_seq_len, cfg.d_model))).astype(np.float32)
    return out


def _jx(b):
    return {k: jnp.asarray(v) for k, v in b.items()}


def _tt(b):
    return {k: torch.from_numpy(np.asarray(v)) for k, v in b.items()}


def _rel(got, want):
    got = np.asarray(got, np.float64)
    want = np.asarray(want, np.float64)
    return float(np.linalg.norm(got - want)
                 / max(np.linalg.norm(want), 1e-30))


def _jax_state(params):
    return JS.TrainState(params, JA.init(params), jnp.zeros((), jnp.int32))


def _names(tree):
    return [n for n, _ in _flatten_with_paths(tree)]


def _leaves(tree):
    """Leaves in ``jax.tree.leaves``' order (dict keys sorted)."""
    return [t for _, t in _flatten_with_paths(tree)]


@functools.lru_cache(maxsize=None)
def _parity(arch):
    """Three steps of each package's train step from the same params and
    batches: losses, step-1 grads and final params, leaf by leaf."""
    cfg = zoo.smoke_cfg(arch)
    tcfg = TC.get_smoke_config(arch).replace(dtype="float32")
    params = JM.init_params(cfg, jax.random.PRNGKey(0))
    tparams = bridge.to_torch(jax.tree.map(np.asarray, params))
    rng = np.random.default_rng(0)
    batches = [_batch(cfg, rng) for _ in range(3)]

    jgrads = jax.jit(jax.grad(lambda p, b: JM.loss_fn(p, cfg, b)[0]))(
        params, _jx(batches[0]))
    jstep = jax.jit(JS.make_train_step(cfg, None))
    jstate, jloss, jmetrics = _jax_state(params), [], []
    for b in batches:
        jstate, m = jstep(jstate, _jx(b))
        jloss.append(float(m["loss"]))
        jmetrics.append({k: float(v) for k, v in m.items()})

    _, _, tgrads = TS.loss_and_grads(tcfg, tparams, _tt(batches[0]))
    tstep = TS.make_train_step(tcfg)
    tstate, tloss, tmetrics = TS.train_state_for(tparams), [], []
    for b in batches:
        tstate, m = tstep(tstate, _tt(b))
        tloss.append(float(m["loss"]))
        tmetrics.append(m)
    return {"jloss": jloss, "tloss": tloss, "jmetrics": jmetrics,
            "tmetrics": tmetrics,
            "grads": list(zip(_names(tgrads), _leaves(tgrads),
                              jax.tree.leaves(jgrads))),
            "params": list(zip(_names(tstate.params),
                               _leaves(tstate.params),
                               jax.tree.leaves(jstate.params))),
            "tstate": tstate, "jstate": jstate}


# ---------------------------------------------------------------------------
# the train step


@pytest.mark.parametrize("arch", ARCHS)
def test_train_step_losses_match_reference(arch):
    run = _parity(arch)
    np.testing.assert_allclose(run["tloss"], run["jloss"], rtol=1e-5)
    assert all(np.isfinite(run["tloss"]))


@pytest.mark.parametrize("arch", ARCHS)
def test_train_step_grads_match_reference(arch):
    run = _parity(arch)
    assert run["grads"], arch
    for name, got, want in run["grads"]:
        assert tuple(got.shape) == tuple(want.shape), name
        assert _rel(got.numpy(), want) < 1e-4, (name, _rel(got.numpy(),
                                                            want))


@pytest.mark.parametrize("arch", ARCHS)
def test_train_step_params_match_reference(arch):
    run = _parity(arch)
    for name, got, want in run["params"]:
        assert got.dtype == torch.float32, name
        assert _rel(got.numpy(), want) < 3e-5, (name, _rel(got.numpy(),
                                                            want))
    assert run["tstate"].step == 3 and run["tstate"].opt.step == 3
    assert int(run["jstate"].step) == 3


@pytest.mark.parametrize("arch", ("qwen3-0.6b", "deepseek-v2-lite-16b",
                                  "zamba2-7b"))
def test_train_step_metrics_match_reference(arch):
    # the reference's metric keys; values left as 0-d tensors (no sync in
    # the step); grad_norm and ce rel 1e-5, aux abs 1e-6
    run = _parity(arch)
    for tm, jm in zip(run["tmetrics"], run["jmetrics"]):
        assert set(tm) == set(jm) == {"loss", "ce", "aux", "grad_norm"}
        assert all(torch.is_tensor(v) and v.dim() == 0 for v in tm.values())
        for key in ("loss", "ce", "grad_norm"):
            np.testing.assert_allclose(float(tm[key]), jm[key], rtol=1e-5)
        np.testing.assert_allclose(float(tm["aux"]), jm["aux"], atol=1e-6)


def test_trainer_schedule_first_step_moves_only_moments():
    # the trainer's cosine schedule (warmup max(1, steps // 20)) is read at
    # the step count before the step: step 1's multiplier is 0, so params
    # are unchanged bit for bit while the moments move — in both packages
    steps = 40
    cfg = zoo.smoke_cfg(SMOKE)
    tcfg = TC.get_smoke_config(SMOKE).replace(dtype="float32")
    params = JM.init_params(cfg, jax.random.PRNGKey(0))
    tparams = bridge.to_torch(jax.tree.map(np.asarray, params))
    b = _batch(cfg, np.random.default_rng(3))
    ocfg = dict(lr=3e-4, weight_decay=0.01)
    jsched = JA.cosine_schedule(1.0, steps, warmup_steps=max(1, steps // 20))
    tsched = TA.cosine_schedule(1.0, steps, warmup_steps=max(1, steps // 20))
    assert tsched(0) == float(jsched(jnp.zeros((), jnp.int32))) == 0.0
    for s in (1, 2, 5, 20, 39, 40):
        np.testing.assert_allclose(tsched(s), float(jsched(jnp.asarray(s))),
                                   rtol=1e-6, atol=1e-7)
    jstate, _ = jax.jit(JS.make_train_step(
        cfg, None, optimizer=JA.AdamWConfig(**ocfg), lr_schedule=jsched))(
            _jax_state(params), _jx(b))
    tstate, _ = TS.make_train_step(
        tcfg, optimizer=TA.AdamWConfig(**ocfg), lr_schedule=tsched)(
            TS.train_state_for(tparams), _tt(b))
    for got, want, p0 in zip(_leaves(tstate.params),
                             jax.tree.leaves(jstate.params),
                             _leaves(tparams)):
        assert torch.equal(got, p0)
        np.testing.assert_array_equal(np.asarray(want), p0.numpy())
    assert any(float(m.abs().sum()) > 0 for m in tree_leaves(tstate.opt.m))
    assert tstate.step == 1 and tstate.opt.step == 1


@pytest.mark.parametrize("arch", ("qwen3-0.6b", "deepseek-v2-lite-16b",
                                  "zamba2-7b", "whisper-base"))
def test_remat_on_and_off_give_equal_bits(arch, monkeypatch):
    # remat recomputes each stacked iteration in the backward (every
    # sub-block of a stacked stage runs twice; deepseek smoke has none),
    # and gives the same loss and grads bit for bit on the CPU
    tcfg = TC.get_smoke_config(arch).replace(dtype="float32")
    params = TM.init_params(tcfg, 0, device="cpu")
    b = _tt(_batch(tcfg, np.random.default_rng(4)))
    calls = []
    apply = TB.apply_sub_block

    def counting(*args, **kw):
        calls.append(args[0])
        return apply(*args, **kw)

    monkeypatch.setattr(TB, "apply_sub_block", counting)
    out = {}
    for remat in (False, True):
        calls.clear()
        loss, metrics, grads = TS.loss_and_grads(
            tcfg.replace(remat=remat), params, b)
        out[remat] = (loss, metrics, tree_leaves(grads), len(calls))
    assert torch.equal(out[True][0], out[False][0])
    assert torch.equal(out[True][1]["aux"], out[False][1]["aux"])
    for g_on, g_off in zip(out[True][2], out[False][2]):
        assert torch.equal(g_on, g_off)
    stacked = any(st.scan and st.n > 1 for st in TB.stage_program(tcfg))
    if stacked:   # remat applies to stacked stages alone, as jax.checkpoint
        assert out[True][3] > out[False][3], (out[True][3], out[False][3])
    else:         # on the scan body does
        assert out[True][3] == out[False][3]


def test_eval_under_no_grad_ignores_train_flag():
    # train=True changes nothing while autograd is off: eval and serving
    # keep their bits
    tcfg = TC.get_smoke_config(SMOKE).replace(dtype="float32")
    params = TM.init_params(tcfg, 0, device="cpu")
    b = _tt(_batch(tcfg, np.random.default_rng(5)))
    with torch.no_grad():
        h0, a0 = TM.forward_hidden(params, tcfg, b)
        h1, a1 = TM.forward_hidden(params, tcfg, b, train=True)
        loss, _ = TM.loss_fn(params, tcfg, b)
    assert torch.equal(h0, h1) and torch.equal(a0, a1)
    assert torch.isfinite(loss)


# ---------------------------------------------------------------------------
# gradient compression


@pytest.mark.parametrize("shape", [(128,), (300,), (7, 50), (4, 128),
                                   (3, 5, 11)])
def test_quantize_matches_reference_bitwise(shape):
    rng = np.random.default_rng(sum(shape))
    g = (rng.standard_normal(shape) * 10.0 ** rng.integers(-6, 2, shape)
         ).astype(np.float32)
    err = (1e-3 * rng.standard_normal(shape)).astype(np.float32)
    if len(shape) == 2:
        g[0] = 0.0   # a block of zeros: scale floored at 1e-12
    jq, js, je = JCMP.quantize(jnp.asarray(g), jnp.asarray(err))
    tq, ts, te = TCMP.quantize(torch.from_numpy(g), torch.from_numpy(err))
    assert tq.dtype == torch.int8 and tuple(tq.shape) == jq.shape
    np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
    np.testing.assert_array_equal(te.numpy(), np.asarray(je))
    np.testing.assert_array_equal(
        TCMP.dequantize(tq, ts, shape).numpy(),
        np.asarray(JCMP.dequantize(jq, js, shape)))


def test_error_feedback_matches_reference_bitwise():
    # three rounds over a tree, the residual carried from round to round
    rng = np.random.default_rng(7)
    tree = {"a": {"w": rng.standard_normal((5, 40))},
            "b": [rng.standard_normal((130,)), None,
                  rng.standard_normal((2, 3))]}
    jerr = terr = None
    for r in range(3):
        grads = tree_map(lambda x: (x * (r + 1)).astype(np.float32), tree)
        jhat, jerr = JCMP.apply_error_feedback(
            jax.tree.map(jnp.asarray, grads), jerr)
        that, terr = TCMP.apply_error_feedback(
            tree_map(torch.from_numpy, grads), terr)
        for got, want in zip(_leaves(that), jax.tree.leaves(jhat)):
            np.testing.assert_array_equal(got.numpy(), np.asarray(want))
        for got, want in zip(_leaves(terr), jax.tree.leaves(jerr)):
            np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert that["b"][1] is None


def test_compressed_ratio_equals_reference():
    assert TCMP.compressed_ratio() == JCMP.compressed_ratio()
    assert TCMP.BLOCK == JCMP.BLOCK == 128


# ---------------------------------------------------------------------------
# the training driver


def _smoke_cfg():
    return TC.get_smoke_config(SMOKE).replace(dtype="float32")


def _train(path, steps, **kw):
    kw = {"batch": 2, "seq_len": 16, "log_every": 1, "device": "cpu", **kw}
    return TT.train(_smoke_cfg(), steps=steps, ckpt_dir=str(path), **kw)


def _assert_states_equal(a, b):
    assert a.step == b.step and a.opt.step == b.opt.step
    for tree_a, tree_b in ((a.params, b.params), (a.opt.m, b.opt.m),
                           (a.opt.v, b.opt.v)):
        for x, y in zip(_leaves(tree_a), _leaves(tree_b)):
            assert torch.equal(x, y)


def test_resume_after_checkpoint_is_bitwise(tmp_path):
    # an uninterrupted 6-step run against one stopped after its step-3
    # checkpoint (the later one removed) and resumed to 6
    full, info = _train(tmp_path / "a", 6, ckpt_every=3)
    assert len(info["losses"]) == 6 and info["step"] == 6
    mgr = CheckpointManager(str(tmp_path / "a"), async_save=False)
    assert mgr.all_steps() == [3, 6]
    shutil.rmtree(tmp_path / "a" / "step_000000006")
    resumed, info2 = _train(tmp_path / "a", 6, ckpt_every=3)
    assert len(info2["losses"]) == 3
    np.testing.assert_array_equal(info2["losses"], info["losses"][3:])
    _assert_states_equal(resumed, full)


def test_straggler_aborts_with_checkpoint_then_resumes_bitwise(tmp_path):
    full, _ = _train(tmp_path / "full", 4, ckpt_every=50)
    state, info = _train(tmp_path / "cut", 4, step_deadline_s=1e-9)
    assert info == {"aborted_straggler": True, "step": 0}
    assert state.step == 1
    mgr = CheckpointManager(str(tmp_path / "cut"), async_save=False)
    assert mgr.all_steps() == [1]
    _, saved = mgr.restore(1, TS.state_for_checkpoint(state), device="cpu")
    _assert_states_equal(TS.state_from_checkpoint(saved), state)
    resumed, info = _train(tmp_path / "cut", 4, ckpt_every=50)
    assert info["step"] == 4 and len(info["losses"]) == 3
    _assert_states_equal(resumed, full)


def test_guard_restores_previous_handler(tmp_path):
    before = signal.getsignal(signal.SIGTERM)
    _train(tmp_path, 1)
    assert signal.getsignal(signal.SIGTERM) is before
    _train(tmp_path / "again", 1)
    assert signal.getsignal(signal.SIGTERM) is before


def test_grad_compression_is_accepted_and_not_applied(tmp_path):
    a, _ = _train(tmp_path / "a", 2)
    b, _ = _train(tmp_path / "b", 2, grad_compression=True)
    _assert_states_equal(a, b)


def _env():
    env = dict(os.environ)
    env["PYTHONPATH"] = str(ROOT / "src")
    return env


def test_sigterm_exits_42_with_checkpoint_at_reached_step(tmp_path):
    script = (
        "from repro_torch import configs\n"
        "from repro_torch.launch import train as T\n"
        f"cfg = configs.get_smoke_config({SMOKE!r}).replace("
        "dtype='float32')\n"
        f"T.train(cfg, steps=100000, batch=2, seq_len=16, ckpt_dir="
        f"{str(tmp_path)!r}, ckpt_every=2, log_every=1, device='cpu')\n")
    proc = subprocess.Popen([sys.executable, "-c", script], env=_env(),
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                            text=True)
    try:
        deadline = time.time() + 240
        while time.time() < deadline and proc.poll() is None:
            if (tmp_path.is_dir() and CheckpointManager(
                    str(tmp_path), async_save=False).latest_step()):
                break
            time.sleep(0.05)
        assert proc.poll() is None, proc.communicate()
        proc.send_signal(signal.SIGTERM)
        out, err = proc.communicate(timeout=240)
    finally:
        if proc.poll() is None:
            proc.kill()
    assert proc.returncode == 42, (out[-2000:], err[-2000:])
    assert "preemption signal" in out
    reached = int(re.findall(r"\[train\] step (\d+)/", out)[-1])
    mgr = CheckpointManager(str(tmp_path), async_save=False)
    assert mgr.latest_step() == reached >= 2
    like = TS.state_for_checkpoint(TS.init_train_state(_smoke_cfg(), 0,
                                                       device="cpu"))
    _, saved = mgr.restore(reached, like, device="cpu")
    assert TS.state_from_checkpoint(saved).step == reached


def test_main_runs_smoke_on_cpu(tmp_path):
    state, info = TT.main(["--smoke", "--device", "cpu", "--steps", "3",
                           "--batch", "2", "--seq-len", "16",
                           "--ckpt-dir", str(tmp_path)])
    assert info["step"] == 3 and state.step == 3
    assert CheckpointManager(str(tmp_path),
                             async_save=False).all_steps() == [3]
    assert all(t.device.type == "cpu" for t in tree_leaves(state.params))


def test_main_without_device_needs_cuda(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("this machine has CUDA: the default device is valid")
    with pytest.raises(RuntimeError, match="CUDA"):
        TT.main(["--smoke", "--steps", "1", "--ckpt-dir",
                 str(tmp_path / "ck")])
    assert not (tmp_path / "ck").exists()


# ---------------------------------------------------------------------------
# train-state checkpoints shared with the JAX package


def test_train_state_names_match_reference(tmp_path):
    # a port TrainState and a JAX TrainState of the same model save the
    # same leaf names, dtypes and shapes; each package restores the other's
    cfg = zoo.smoke_cfg(SMOKE)
    params = JM.init_params(cfg, jax.random.PRNGKey(0))
    jstate = _jax_state(params)
    tstate = TS.train_state_for(bridge.to_torch(jax.tree.map(np.asarray,
                                                             params)))
    JCheckpointManager(str(tmp_path / "j")).save(0, jstate, blocking=True)
    CheckpointManager(str(tmp_path / "t")).save(
        0, TS.state_for_checkpoint(tstate), blocking=True)
    jm = CheckpointManager(str(tmp_path / "j"), async_save=False).manifest()
    tm = CheckpointManager(str(tmp_path / "t"), async_save=False).manifest()
    key = [(e["name"], e["dtype"], e["shape"]) for e in jm["leaves"]]
    assert key == [(e["name"], e["dtype"], e["shape"]) for e in tm["leaves"]]
    assert ("opt/step", "int32", []) in key and ("step", "int32", []) in key
    _, back = JCheckpointManager(str(tmp_path / "t"), async_save=False
                                 ).restore(0, jstate)
    for got, want in zip(jax.tree.leaves(back), jax.tree.leaves(jstate)):
        np.testing.assert_array_equal(np.asarray(got), np.asarray(want))


def test_resumes_jax_saved_train_state(tmp_path):
    # the JAX package trains 2 steps (the trainer's schedule, the port's
    # batches as numpy) and saves its TrainState; the port's trainer
    # restores it and runs step 3 on the same batch: loss rel 1e-5, params
    # rel 3e-5 (the module docstring's reason)
    steps, batch, seq = 3, 2, 16
    cfg = zoo.smoke_cfg(SMOKE)
    params = JM.init_params(cfg, jax.random.PRNGKey(0))
    it = make_batch_iterator(_smoke_cfg(), batch, seq, seed=0, device="cpu")
    batches = [{k: v.numpy() for k, v in next(it).items()}
               for _ in range(steps)]
    jstep = jax.jit(JS.make_train_step(
        cfg, None, optimizer=JA.AdamWConfig(lr=3e-4, weight_decay=0.01),
        lr_schedule=JA.cosine_schedule(1.0, steps,
                                       warmup_steps=max(1, steps // 20))))
    state = _jax_state(params)
    for b in batches[:2]:
        state, _ = jstep(state, _jx(b))
    JCheckpointManager(str(tmp_path)).save(2, state, blocking=True)
    state3, m3 = jstep(state, _jx(batches[2]))
    tstate, info = _train(tmp_path, steps, batch=batch, seq_len=seq)
    assert len(info["losses"]) == 1 and tstate.step == 3
    np.testing.assert_allclose(info["losses"][0], float(m3["loss"]),
                               rtol=1e-5)
    for got, want in zip(_leaves(tstate.params),
                         jax.tree.leaves(state3.params)):
        assert _rel(got.numpy(), want) < 3e-5
