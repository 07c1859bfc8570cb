"""qwen3-0.6b, granite-3-8b and phi3-medium-14b on the CPU: each smoke
config compressed by both packages and served by both.

The three are dense GQA ``"attn"`` models like llama: qwen3 with qk_norm
(so its caches stay dense) and tied embeddings, granite (head dim 8, GQA 4)
and phi3-medium (head dim 20, d_model 80) without qk_norm, so their
compressed models serve over the latent {"lk", "lv"} cache in the engine.
Compression runs on 8 x 32 uniform numpy tokens (ratio 0.6, fused, one
refine epoch, microbatch 2), one JAX and one port run per arch shared by
the module.  The JAX servers get an Auto-axis mesh (its default mesh is
Explicit on jax 0.9, which its sharding constraints reject).
"""

from __future__ import annotations

import torch_thread_cap  # noqa: F401  (thread caps under pytest-xdist)
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import AxisType

from repro.configs import get_smoke_config as j_smoke
from repro.core import CompressConfig as JCompressConfig
from repro.core import compress_model as j_compress_model
from repro.launch import serve as JS
from repro.models import model as JM
from repro_torch import bridge
from repro_torch import configs as TC
from repro_torch.core import pipeline as TP
from repro_torch.launch import serve as TS
from repro_torch.models import model as TM

ARCHS = ["qwen3-0.6b", "granite-3-8b", "phi3-medium-14b"]
RECIPE = dict(ratio=0.6, rank_multiple=1, microbatch=2, calib_mode="fused",
              refine_epochs=1)


def _auto_mesh():
    return jax.make_mesh((1, 1), ("data", "model"),
                         axis_types=(AxisType.Auto,) * 2)


def _ppl(loss, params, cfg, batches, to):
    tot = sum(float(loss(params, cfg, {k: to(v) for k, v in b.items()})[0])
              for b in batches)
    return float(np.exp(tot / len(batches)))


@pytest.fixture(scope="module", params=ARCHS)
def run(request):
    arch = request.param
    jcfg = j_smoke(arch).replace(dtype="float32")
    tcfg = TC.get_smoke_config(arch).replace(dtype="float32")
    dense = jax.tree.map(np.asarray,
                         JM.init_params(jcfg, jax.random.PRNGKey(0)))
    rng = np.random.default_rng(0)
    toks = rng.integers(0, jcfg.vocab_size, (8, 32)).astype(np.int32)
    evals = []
    for _ in range(2):
        t = rng.integers(0, jcfg.vocab_size, (4, 33)).astype(np.int32)
        evals.append({"tokens": t[:, :-1], "labels": t[:, 1:]})
    jc, jrep = j_compress_model(jax.tree.map(jnp.asarray, dense), jcfg,
                                {"tokens": jnp.asarray(toks)},
                                JCompressConfig(**RECIPE))
    tc, trep = TP.compress_model(bridge.to_torch(dense), tcfg,
                                 {"tokens": toks},
                                 TP.CompressConfig(**RECIPE), device="cpu")
    return dict(arch=arch, jcfg=jcfg, tcfg=tcfg, jc=jc, jrep=jrep, tc=tc,
                trep=trep, evals=evals)


def _factor_pairs(tree):
    """Every factorized linear's {"v", "u"} of a param tree, in order."""
    out = []
    if isinstance(tree, dict):
        if "u" in tree and "v" in tree:
            return [tree]
        for key in sorted(tree):
            out += _factor_pairs(tree[key])
    elif isinstance(tree, (list, tuple)):
        for item in tree:
            out += _factor_pairs(item)
    return out


def test_compress_matches_reference(run):
    # ranks integer-equal, every linear's composed map within 1e-3
    # relative Frobenius, the report's keys, ppl within 0.5 %
    jrep, trep = run["jrep"], run["trep"]
    assert [u["name"] for u in trep["units"]] \
        == [u["name"] for u in jrep["units"]]
    for ju, tu in zip(jrep["units"], trep["units"]):
        assert set(tu) == set(ju)
        assert [lin["rank"] for lin in tu["linears"]] \
            == [lin["rank"] for lin in ju["linears"]]
    jpairs = _factor_pairs(jax.tree.map(np.asarray, run["jc"]["stages"]))
    tpairs = _factor_pairs(run["tc"]["stages"])
    assert len(jpairs) == len(tpairs) == 7
    for jp, tp in zip(jpairs, tpairs):
        want = np.einsum("lnk,lkm->lnm", jp["v"], jp["u"])
        got = torch.einsum("lnk,lkm->lnm", tp["v"], tp["u"]).numpy()
        for layer in range(want.shape[0]):
            err = (np.linalg.norm(got[layer] - want[layer])
                   / np.linalg.norm(want[layer]))
            assert err <= 1e-3, (run["arch"], err)
    jppl = _ppl(JM.loss_fn, run["jc"], run["jcfg"], run["evals"],
                jnp.asarray)
    with torch.no_grad():
        tppl = _ppl(TM.loss_fn, run["tc"], run["tcfg"], run["evals"],
                    torch.from_numpy)
    assert abs(tppl / jppl - 1.0) <= 5e-3, (tppl, jppl)


def test_serving_matches_reference(run):
    # the JAX package's compressed weights, bridged: Server (3 prompts of
    # 10 tokens on 4 slots, 8 steps) and the engine (3 requests on 2 slots,
    # whole padded and 8-token chunked prefill) give the JAX package's
    # tokens; granite and phi3-medium serve the engine over the latent
    # cache, qwen3 (qk_norm) over the dense one
    jcfg, tcfg = run["jcfg"], run["tcfg"]
    host = jax.tree.map(np.asarray, run["jc"])
    jp, tp = jax.tree.map(jnp.asarray, host), bridge.to_torch(host)
    cache = TM.init_cache(tcfg, 1, 8, params=tp, device="cpu")
    latent = run["arch"] != "qwen3-0.6b"
    assert ("lk" in cache[0][0]) == latent
    prompts = np.random.default_rng(2).integers(
        0, jcfg.vocab_size, (3, 10)).astype(np.int32)
    want = JS.Server(jcfg, jp, max_len=32, batch=4, mesh=_auto_mesh()
                     ).generate(jnp.asarray(prompts), steps=8)
    got = TS.Server(tcfg, tp, max_len=32, batch=4, device="cpu"
                    ).generate(prompts, steps=8)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))

    def requests(module):
        rng = np.random.default_rng(3)
        return [module.Request(rid=i, prompt=rng.integers(
            0, jcfg.vocab_size, (n,)).astype(np.int32), steps=s)
            for i, (n, s) in enumerate(zip((5, 13, 9), (6, 4, 7)))]

    for chunk in (0, 8):
        jeng = JS.ContinuousBatchingServer(jcfg, jp, max_len=40, slots=2,
                                           prefill_chunk=chunk,
                                           mesh=_auto_mesh())
        want = jeng.run(requests(JS))
        teng = TS.ContinuousBatchingServer(tcfg, tp, max_len=40, slots=2,
                                           prefill_chunk=chunk, device="cpu")
        got = teng.run(requests(TS))
        assert sorted(got) == sorted(want)
        for rid in want:
            np.testing.assert_array_equal(got[rid]["tokens"],
                                          want[rid]["tokens"])
        assert teng.prefill_routes == jeng.prefill_routes
