"""The zoo recipe in the port against the JAX package's harness, on
llama-7b and deepseek-v2-lite-16b smoke (deepseek under its own capacity
dispatch).

``repro.core.zoo.compress_smoke(arch)`` gives the JAX package's dense
params, compressed params and report; its calibration set
(``repro.data.calibration_set``, 4 × 32 tokens) goes to the port as numpy,
with the dense params through ``repro_torch.bridge``.  The port compresses
at ``zoo.SMOKE_COMPRESS`` and must give:

* ranks integer-equal;
* unit 0's composed maps ``v @ u`` within 2e-3 as they act on the stream
  they were solved on: ||X′(W_port − W_jax)||_F / ||X′ W_jax||_F from the
  port's X′ᵀX′.  The zoo set holds only 40 distinct tokens, so the taps'
  covariances are rank deficient (ROADMAP hazard 3d) and the maps'
  null-space directions are fixed by rounding alone: unit 0's raw maps
  differ by up to 5.7e-2 (llama) and 0.11 (deepseek).  On the stream they
  agree, but the eigenvalue floor of the whitening (1e-6·λmax) still
  magnifies rounding in the near-null directions, so the gap moves with
  the port's thread count alone (measured on the CPU at 1, 2, 4 and 8
  threads: llama's ``ffn.down`` 1.08e-3, 1.13e-3, 1.29e-3, 5.6e-4;
  deepseek's worst 1.8e-4 to 3.1e-4).  The pipeline tests hold maps to
  1e-3 on a full-rank set; here twice that covers the measured spread.
  Unit 1 reads unit 0's refined output, and one Adam epoch on that
  rank-deficient stream moves it apart (llama 1.3e-2 on the stream;
  deepseek's expert banks 0.49, and its unit-1 post-refine MSE 175
  against 231): unit 1 is not held, the ppl is;
* unit 0's pre-refine MSE to rtol 5e-3 (identical input streams);
* the smoke ppl within 2.5 % of the JAX package's on the harness's own
  eval batches (measured: 1.74 % llama, 2.18 % deepseek).

Then the JAX package's checkpoint of its compressed tree, padded (step 0)
and re-sliced (step 1), restores in the port bit for bit against the
tree's numpy, and ``Server.from_checkpoint`` on it decodes the JAX
``Server``'s tokens (an Auto-axis mesh, ROADMAP hazard 3a) on the
harness's prompts as numpy.
"""

from __future__ import annotations

import torch_thread_cap  # noqa: F401  (thread caps under pytest-xdist)
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import AxisType

from repro.checkpoint.manager import CheckpointManager as JManager
from repro.core import zoo as JZ
from repro.data import calibration_set, make_batch_iterator
from repro.launch import serve as JS
from repro_torch import bridge
from repro_torch.checkpoint import CheckpointManager
from repro_torch.core import pipeline as TP
from repro_torch.core import zoo as TZ
from repro_torch.launch import serve as TS
from repro_torch.models import model as TM
from test_torch_adaptive import _factor_maps, map_errors

pytestmark = pytest.mark.zoo_smoke

ARCHS = ("llama-7b", "deepseek-v2-lite-16b")


def _auto_mesh():
    return jax.make_mesh((1, 1), ("data", "model"),
                         axis_types=(AxisType.Auto,) * 2)


def _np_tree(tree):
    return jax.tree.map(np.asarray, tree)


@pytest.fixture(scope="module", params=ARCHS)
def run(request, tmp_path_factory):
    arch = request.param
    cfg, dense, jc, jrep = JZ.compress_smoke(arch)
    toks = np.asarray(calibration_set(cfg, JZ.SMOKE_CALIB["n"],
                                      JZ.SMOKE_CALIB["seq_len"])["tokens"])
    tcfg = TZ.smoke_cfg(arch)
    tparams = bridge.to_torch(_np_tree(dense))
    tc, trep = TP.compress_model(tparams, tcfg, {"tokens": toks},
                                 TP.CompressConfig(**TZ.SMOKE_COMPRESS),
                                 device="cpu")
    # the same compression again, with each tap's covariances reported
    tc_dbg, trep_dbg = TP.compress_model(
        tparams, tcfg, {"tokens": toks},
        TP.CompressConfig(**TZ.SMOKE_COMPRESS, debug_covs=True),
        device="cpu")
    data = make_batch_iterator(cfg, 8, 64, seed=99)
    evals = [{k: np.asarray(v) for k, v in next(data).items()}
             for _ in range(2)]
    with torch.no_grad():
        tot = sum(float(TM.loss_fn(tc, tcfg, {k: torch.from_numpy(v.copy())
                                             for k, v in b.items()})[0])
                  for b in evals)
    # the JAX package's checkpoints of its own compressed tree
    workdir = tmp_path_factory.mktemp(f"jz_{arch.replace('.', '_')}")
    mgr = JManager(str(workdir), async_save=False)
    meta = {"arch": arch, "compress": dict(JZ.SMOKE_COMPRESS)}
    mgr.save(0, jc, blocking=True, meta=meta)
    mgr.save(1, jc, blocking=True, meta=meta, reslice_banks=True)
    prompts = np.array(JZ.smoke_inputs(cfg)[0])
    b, plen = JZ.SMOKE_PROMPTS["batch"], JZ.SMOKE_PROMPTS["prompt_len"]
    steps = JZ.SMOKE_DECODE_STEPS
    max_len = plen + steps + 8
    jtoks = np.asarray(JS.Server(cfg, jc, max_len=max_len, batch=b,
                                 mesh=_auto_mesh()).generate(
        jnp.asarray(prompts), steps=steps))
    return dict(arch=arch, cfg=cfg, tcfg=tcfg, jc=jc, jrep=jrep, tc=tc,
                trep=trep, tc_dbg=tc_dbg, trep_dbg=trep_dbg,
                ppl_jax=JZ.smoke_ppl(jc, cfg),
                ppl_port=float(np.exp(tot / len(evals))), workdir=workdir,
                prompts=prompts, jtoks=jtoks, max_len=max_len, batch=b,
                steps=steps)


def _ranks(report):
    return [[(lin["path"], lin["rank"]) for lin in u.get("linears", [])]
            for u in report["units"]]


def test_ranks_equal(run):
    assert _ranks(run["trep"]) == _ranks(run["jrep"])
    assert any(r for r in _ranks(run["trep"]))


def test_debug_covs_leave_the_compression_unchanged(run):
    assert TZ.bit_mismatches(run["tc"], run["tc_dbg"]) == []


def test_unit0_maps_on_their_stream(run):
    trep = run["trep_dbg"]
    for u in trep["units"]:     # every tap compared on its own stream
        u["replay_taps"] = list(u["covs"])
    errs, _ = map_errors(_np_tree(run["jc"]), run["tc_dbg"], run["tcfg"],
                         trep)
    unit0 = {k: v for k, v in errs.items() if k[1] == 0}
    assert len(unit0) >= 7
    worst = max(unit0, key=unit0.get)
    assert unit0[worst] <= 2e-3, (worst, unit0[worst])


def test_maps_have_the_reference_shapes(run):
    want, got = _factor_maps(_np_tree(run["jc"])), _factor_maps(run["tc"])
    assert sorted(got) == sorted(want)
    assert all(got[k].shape == want[k].shape for k in want)
    assert all(np.isfinite(got[k]).all() for k in got)


def test_unit0_pre_refine_mse(run):
    np.testing.assert_allclose(run["trep"]["units"][0]["pre_refine_mse"],
                               run["jrep"]["units"][0]["pre_refine_mse"],
                               rtol=5e-3)


def test_ppl_within_2_5_percent(run):
    got, want = run["ppl_port"], run["ppl_jax"]
    assert abs(got / want - 1) <= 2.5e-2, (got, want)


@pytest.mark.parametrize("step", [0, 1])
def test_jax_checkpoint_restores_bit_for_bit(run, step):
    _, tree, meta = CheckpointManager(
        str(run["workdir"]), async_save=False).restore_tree(step,
                                                            device="cpu")
    assert meta["arch"] == run["arch"]
    assert TZ.bit_mismatches(tree, _np_tree(run["jc"])) == []
    assert JZ.bit_mismatches(bridge.to_numpy(tree), run["jc"]) == []


@pytest.mark.parametrize("step", [0, 1])
def test_from_checkpoint_decodes_the_jax_servers_tokens(run, step):
    srv = TS.Server.from_checkpoint(run["tcfg"], str(run["workdir"]),
                                    step=step, max_len=run["max_len"],
                                    batch=run["batch"], device="cpu")
    assert srv.checkpoint_meta["arch"] == run["arch"]
    got = srv.generate(run["prompts"], steps=run["steps"])
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), run["jtoks"])
