"""The port's arch-zoo conformance harness (``repro_torch.core.zoo``) on the
CPU, for every registered arch.

* ``roundtrip``: compress at the zoo recipe → checkpoint padded and
  re-sliced → ``Server.from_checkpoint`` → decode.  Bit parity of both
  restores, token parity of the three servers, the manifest's meta, bank
  metadata by family (``rank_per_expert`` entries for the MoE archs
  alone), and the smoke ppl ratio inside the arch's checked-in envelope
  (``tests/conformance/envelopes.json``, read, never written).  The
  envelope's ``min_tokens_per_s`` was set for the JAX package on a CPU
  runner and is not a gate here: a CPU's decode speed under a parallel
  test run says nothing about the port.
* The record carries the JAX harness's keys (read from
  ``src/repro/core/zoo.py``: the JAX ``roundtrip`` itself fails on this
  jax, ROADMAP hazard 3a).
* The report-schema goldens of ``tests/conformance/test_report_schema.py``
  hold on the port's reports.
* The recipe constants equal the JAX package's, and ``bit_mismatches`` /
  ``check_envelope`` give the JAX functions' messages on the same numpy
  trees and records.
"""

from __future__ import annotations

import torch_thread_cap  # noqa: F401  (thread caps under pytest-xdist)
import ast
import importlib.util
import pathlib

import ml_dtypes
import numpy as np
import pytest
import torch

from repro.core import zoo as JZ
from repro_torch import bridge
from repro_torch.configs import ALL_ARCHS
from repro_torch.core import zoo as TZ

pytestmark = pytest.mark.zoo_smoke

ROOT = pathlib.Path(__file__).resolve().parents[1]
ENVELOPES = ROOT / "tests" / "conformance" / "envelopes.json"
MOE_ARCHS = {"deepseek-v2-lite-16b", "kimi-k2-1t-a32b"}


def _schema():
    path = ROOT / "tests" / "conformance" / "test_report_schema.py"
    spec = importlib.util.spec_from_file_location("_report_schema", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


SCHEMA = _schema()
_CACHE = {}


@pytest.fixture(scope="module")
def zoo_run(tmp_path_factory):
    """``zoo_run(arch) -> (record, report)``: one CPU roundtrip an arch."""
    def get(arch):
        if arch not in _CACHE:
            workdir = tmp_path_factory.mktemp(f"zoo_{arch.replace('.', '_')}")
            _CACHE[arch] = TZ.roundtrip(arch, str(workdir), device="cpu")
        return _CACHE[arch]
    return get


@pytest.fixture(scope="module")
def envelopes():
    return TZ.load_envelopes(str(ENVELOPES))


# ---------------------------------------------------------------------------
# the round trip, every arch


@pytest.mark.parametrize("arch", ALL_ARCHS)
def test_roundtrip_conformance(arch, zoo_run, envelopes):
    record, _ = zoo_run(arch)
    assert record["bit_parity"], record["mismatches"]
    assert record["resliced_parity"], record["mismatches"]
    assert record["token_match"], f"{arch}: restored servers diverged"
    assert record["checkpoint_meta_ok"]
    env = envelopes[arch]
    assert record["ppl_ratio"] <= env["max_ppl_ratio"], (
        record["ppl_ratio"], env)
    assert np.isfinite(record["ppl_dense"]) and record["ppl_dense"] > 1
    assert record["tokens_per_s"] > 0 and record["units"] > 0
    # the record passes the envelope but for the CPU-runner speed floor
    bad = TZ.check_envelope(record, env)
    assert all(v.startswith("tokens_per_s") for v in bad), bad


@pytest.mark.parametrize("arch", ALL_ARCHS)
def test_moe_bank_rank_metadata(arch, zoo_run):
    record, _ = zoo_run(arch)
    assert (record["family"] == "moe") == (arch in MOE_ARCHS)
    if record["family"] == "moe":
        assert record["bank_leaves"] > 0, record
    else:
        assert record["bank_leaves"] == 0, record


def _jax_record_keys():
    """The keys of the dict literal bound to ``record`` in the JAX
    package's ``zoo.roundtrip``."""
    tree = ast.parse(pathlib.Path(JZ.__file__).read_text())
    fn = next(n for n in ast.walk(tree) if isinstance(n, ast.FunctionDef)
              and n.name == "roundtrip")
    rec = next(n.value for n in ast.walk(fn) if isinstance(n, ast.Assign)
               and any(isinstance(t, ast.Name) and t.id == "record"
                       for t in n.targets))
    return {k.value for k in rec.keys}


@pytest.mark.parametrize("arch", ALL_ARCHS)
def test_record_keys_match_the_jax_harness(arch, zoo_run):
    record, _ = zoo_run(arch)
    keys = _jax_record_keys()
    assert len(keys) == 17
    assert set(record) == keys
    # what the benchmark schema's zoo rows name, with its types
    for key in ("arch", "bit_parity", "resliced_parity", "token_match",
                "ppl_ratio", "tokens_per_s"):
        assert key in record
    assert isinstance(record["ppl_ratio"], float)
    assert isinstance(record["tokens_per_s"], float)
    assert record["arch"] == arch


# ---------------------------------------------------------------------------
# the report-schema goldens on the port's reports


@pytest.mark.parametrize("kind", sorted(SCHEMA.REPRESENTATIVES))
def test_report_schema_golden(kind, zoo_run):
    SCHEMA.test_report_schema_golden(kind, zoo_run)


def test_hybrid_reports_shared_reuse(zoo_run):
    SCHEMA.test_hybrid_reports_shared_reuse(zoo_run)


def test_moe_drop_rate_accounting(zoo_run):
    SCHEMA.test_moe_drop_rate_accounting(zoo_run)


# ---------------------------------------------------------------------------
# the recipe, the inputs and the helpers against the JAX package's


def test_constants_equal_the_jax_harness():
    assert TZ.SMOKE_COMPRESS == JZ.SMOKE_COMPRESS
    assert TZ.SMOKE_CALIB == JZ.SMOKE_CALIB
    assert TZ.SMOKE_PROMPTS == JZ.SMOKE_PROMPTS
    assert TZ.SMOKE_DECODE_STEPS == JZ.SMOKE_DECODE_STEPS


@pytest.mark.parametrize("arch", ["llama-7b", "whisper-base",
                                  "phi-3-vision-4.2b"])
def test_smoke_cfg_and_inputs(arch):
    cfg, jcfg = TZ.smoke_cfg(arch), JZ.smoke_cfg(arch)
    assert cfg.dtype == jcfg.dtype == "float32"
    assert cfg.d_model == jcfg.d_model and cfg.vocab_size == jcfg.vocab_size
    prompts, extras = TZ.smoke_inputs(cfg, device="cpu")
    jprompts, jextras = JZ.smoke_inputs(jcfg)
    assert tuple(prompts.shape) == np.asarray(jprompts).shape
    assert prompts.dtype == torch.int32
    assert bool(((prompts >= 0) & (prompts < cfg.vocab_size)).all())
    assert sorted(extras) == sorted(jextras)
    for k, v in extras.items():
        assert tuple(v.shape) == np.asarray(jextras[k]).shape
        assert v.dtype == torch.float32
    again, again_x = TZ.smoke_inputs(cfg, device="cpu")
    assert torch.equal(prompts, again)
    assert all(torch.equal(extras[k], again_x[k]) for k in extras)
    other, _ = TZ.smoke_inputs(cfg, seed=8, device="cpu")
    assert not torch.equal(prompts, other)


def _arr(*shape, seed=0, dtype=np.float32):
    return np.random.default_rng(seed).standard_normal(shape).astype(dtype)


def _tree_cases():
    a, b, c = _arr(3, 4), _arr(5, seed=1), _arr(2, 2, seed=2)
    neg = np.array([-0.0, 1.0], np.float32)
    pos = np.array([0.0, 1.0], np.float32)
    half_neg = neg.astype(ml_dtypes.bfloat16)
    half_pos = pos.astype(ml_dtypes.bfloat16)
    return {
        "equal": ({"a": a, "s": [b, {"c": c}]},
                  {"a": a.copy(), "s": [b.copy(), {"c": c.copy()}]}),
        "neg_zero": ({"a": a, "z": neg}, {"a": a, "z": pos}),
        "bf16_neg_zero": ({"z": half_neg}, {"z": half_pos}),
        "bf16_equal": ({"z": half_neg}, {"z": half_neg.copy()}),
        "dtype": ({"a": a}, {"a": a.astype(np.float64)}),
        "int_dtype": ({"i": np.arange(4, dtype=np.int32)},
                      {"i": np.arange(4, dtype=np.int64)}),
        "shape": ({"a": a}, {"a": a.reshape(4, 3)}),
        "names": ({"a": a, "b": b}, {"a": a, "c": b}),
        "extra_leaf": ({"a": a}, {"a": a, "b": b}),
        "list_vs_tuple": ({"s": [a, b]}, {"s": (a, b)}),
        "none_slot": ({"s": [None, a]}, {"s": (None, a)}),
        "several": ({"a": a, "b": b, "z": neg},
                    {"a": a.astype(np.float64), "b": b[:4], "z": pos}),
    }


@pytest.mark.parametrize("case", sorted(_tree_cases()))
def test_bit_mismatches_match_the_jax_function(case):
    x, y = _tree_cases()[case]
    want = JZ.bit_mismatches(x, y)
    assert TZ.bit_mismatches(x, y) == want
    assert bool(want) == (case not in ("equal", "bf16_equal",
                                       "list_vs_tuple", "none_slot"))


@pytest.mark.parametrize("case", sorted(_tree_cases()))
def test_bit_mismatches_on_torch_leaves(case):
    """A torch tree against the numpy tree it was made from is equal bit
    for bit (bf16 included), and torch trees give the numpy trees'
    messages."""
    x, y = _tree_cases()[case]
    assert TZ.bit_mismatches(bridge.to_torch(x), x) == []
    assert TZ.bit_mismatches(bridge.to_torch(x), bridge.to_torch(y)) == \
        JZ.bit_mismatches(x, y)


def _record(**kw):
    rec = {"arch": "llama-7b", "bit_parity": True, "resliced_parity": True,
           "token_match": True, "mismatches": [], "ppl_ratio": 1.0,
           "tokens_per_s": 2000.0}
    rec.update(kw)
    return rec


ENV = {"max_ppl_ratio": 1.095, "min_tokens_per_s": 1023.0}
RECORDS = {
    "inside": (_record(), ENV),
    "no_envelope": (_record(), None),
    "bit_parity": (_record(bit_parity=False,
                           mismatches=["a: bytes differ"]), ENV),
    "resliced": (_record(resliced_parity=False,
                         mismatches=["b: shape (2,) != (3,)"]), ENV),
    "tokens": (_record(token_match=False), ENV),
    "ppl": (_record(ppl_ratio=1.2345), ENV),
    "ppl_at_limit": (_record(ppl_ratio=1.095), ENV),
    "speed": (_record(tokens_per_s=12.34), ENV),
    "everything": (_record(bit_parity=False, resliced_parity=False,
                           token_match=False, ppl_ratio=2.0,
                           tokens_per_s=1.0, mismatches=["x"]), ENV),
}


@pytest.mark.parametrize("case", sorted(RECORDS))
def test_check_envelope_matches_the_jax_function(case):
    rec, env = RECORDS[case]
    want = JZ.check_envelope(rec, env)
    assert TZ.check_envelope(rec, env) == want
    assert bool(want) == (case not in ("inside", "ppl_at_limit"))


def test_envelopes_cover_every_arch(envelopes):
    assert sorted(envelopes) == sorted(ALL_ARCHS)
    assert envelopes == JZ.load_envelopes(str(ENVELOPES))
