"""The kernel-contract pass of the port (``repro_torch.analysis.contracts``
driving ``repro_torch.kernels.contracts``): the repo's contracts hold, and
each rule fires on a contract or lattice a test breaks — all on the host.
The counterpart of ``tests/test_analysis_contracts.py``."""

from __future__ import annotations

import torch_thread_cap  # noqa: F401  (thread caps under pytest-xdist)
from dataclasses import replace

import pytest
import torch

from repro_torch.analysis.contracts import (check_contract,
                                            check_kernel_contracts)
from repro_torch.kernels import autotune, ops
from repro_torch.kernels import cov_accum as cov
from repro_torch.kernels import lowrank_matmul as low
from repro_torch.kernels.autotune import Candidate
from repro_torch.kernels.contracts import CONTRACTS


def _rules(findings):
    return sorted(f.rule for f in findings)


def _cov_contract(probe, cands, **kw):
    return CONTRACTS["cov_accum"]._replace(
        probes=(probe,), candidates=lambda p: cands, **kw)


def _cov_plan(rows=512, n=256, splits=1):
    p = cov.plan(rows, n, torch.bfloat16)
    per = rows if splits == 1 else -(-rows // splits // p.step) * p.step
    return replace(p, splits=-(-rows // per), rows_per_split=per)


PROBE = {"t": 512, "n": 256, "dtype": "bfloat16"}


class TestRepoContractsHold:
    def test_full_pass_clean_and_the_d80_probe_refused(self):
        refused = []
        findings = check_kernel_contracts(refused=refused)
        assert findings == [], "\n".join(f.format() for f in findings)
        assert len(refused) == 2      # D 80 in fp32 and bf16
        assert all("flash_decode" in r and "d=80" in r and "refused" in r
                   for r in refused)

    def test_registry_covers_all_wrappers(self):
        assert set(ops.REGISTERED_KERNELS.values()) == set(CONTRACTS)
        assert set(CONTRACTS) == set(autotune._LATTICES)
        assert set(CONTRACTS) == set(autotune._ANCHORS)
        for wrapper in ops.REGISTERED_KERNELS:
            assert callable(getattr(ops, wrapper))
        assert {"lowrank_matmul", "lowrank_down", "lowrank_up", "cov_accum",
                "cov_accum_banked", "cov_accum_grouped", "flash_attention",
                "flash_decode", "grouped_matmul"} == set(ops.REGISTERED_KERNELS)

    def test_every_contract_has_probes_in_both_dtypes_and_a_ragged_one(self):
        for name, contract in CONTRACTS.items():
            dtypes = {p["dtype"] for p in contract.probes}
            assert dtypes == {"float32", "bfloat16"}, name
            assert any(any(isinstance(v, int) and v % 128
                           for v in probe.values())
                       for probe in contract.probes), name

    def test_the_ports_head_dims_are_probed(self):
        fa = {p["d"] for p in CONTRACTS["flash_attention"].probes}
        fd = {p["d"] for p in CONTRACTS["flash_decode"].probes}
        assert {96, 112, 192, 256} <= fa and {8, 20, 96, 112} <= fd
        assert {p["d"] for p in CONTRACTS["flash_decode"].refused} == {80}

    def test_every_lattice_is_reached(self):
        # each tuned knob has a probe where the lattice holds more than one
        # candidate (flash_decode's SPAN is compiled: one plan everywhere)
        for name in ("cov_accum", "lowrank_matmul", "flash_attention",
                     "grouped_matmul"):
            c = CONTRACTS[name]
            assert max(len(c.candidates(p)) for p in c.probes) > 1, name
        c = CONTRACTS["flash_decode"]
        assert {len(c.candidates(p)) for p in c.probes} == {1}


class TestSeededViolations:
    def test_orphaned_lattice_is_a_registry_finding(self, monkeypatch):
        monkeypatch.setitem(autotune._LATTICES, "ghost_kernel", {"x": (1,)})
        monkeypatch.setitem(autotune._ANCHORS, "ghost_kernel", cov.plan)
        got = [f for f in check_kernel_contracts()
               if f.rule == "contract-registry"]
        assert any("ghost_kernel" in f.message and "no KernelContract"
                   in f.message for f in got)

    def test_orphaned_registry_entry_is_a_finding(self, monkeypatch):
        monkeypatch.setitem(ops.REGISTERED_KERNELS, "ghost_wrapper",
                            "ghost_contract")
        from repro_torch.analysis import contracts as AC
        out = []
        AC._check_registry(out)
        msgs = [f.message for f in out]
        assert any("missing ops wrapper 'ghost_wrapper'" in m for m in msgs)
        assert any("unknown contract 'ghost_contract'" in m for m in msgs)
        assert {f.rule for f in out} == {"contract-registry"}

    def test_misaligned_slice_is_caught(self):
        # a split whose slices are not whole steps: the launcher would
        # refuse it (rows_per_split % STEP) on the card
        good = _cov_plan(splits=2)
        bad = replace(good, rows_per_split=300, splits=2)
        got = check_contract(_cov_contract(PROBE, [
            Candidate(good, 10_000, 0.0), Candidate(bad, 10_000, 0.0)]))
        assert "contract-alignment" in _rules(got)
        assert any("rows_per_split=300" in f.message for f in got)

    def test_over_budget_candidate_is_caught(self):
        p = _cov_plan()
        got = check_contract(_cov_contract(PROBE, [
            Candidate(p, 10 * 2 ** 30, 0.0)]))
        assert _rules(got) == ["contract-smem"]

    def test_grid_past_the_limit_is_caught(self, monkeypatch):
        monkeypatch.setattr(autotune, "grid", lambda k, p: (1, 70000, 1))
        got = check_contract(_cov_contract(PROBE, [
            Candidate(_cov_plan(), 10_000, 0.0)]))
        assert _rules(got) == ["contract-smem"]
        assert "grid" in got[0].message

    def test_wasteful_candidate_is_caught(self):
        anchor, other = _cov_plan(), _cov_plan(splits=2)
        got = check_contract(_cov_contract(PROBE, [
            Candidate(anchor, 10_000, 0.0), Candidate(other, 10_000, 5.0)]))
        assert _rules(got) == ["contract-waste"]
        # the sole candidate may waste what it must
        got = check_contract(_cov_contract(PROBE, [
            Candidate(other, 10_000, 5.0)]))
        assert got == []

    def test_candidate_whose_emulation_raises_is_caught(self):
        # a slice count the slices do not cover: the emulation fails
        p = _cov_plan(splits=2)
        bad = replace(p, rows_per_split=64)
        got = check_contract(_cov_contract(PROBE, [
            Candidate(_cov_plan(), 10_000, 0.0), Candidate(bad, 10_000, 0.0)
        ], evaluate=lambda probe, plan: (_ for _ in ()).throw(
            IndexError("slice past T")) if plan is bad
            else CONTRACTS["cov_accum"].evaluate(probe, plan)))
        assert _rules(got) == ["contract-eval"]
        assert "emulation failed" in got[0].message

    def test_emulation_off_the_plain_version_is_caught(self):
        # slices that drop rows: the emulation runs but misses the tail
        p = _cov_plan(splits=2)
        bad = replace(p, splits=1, rows_per_split=256)
        got = check_contract(_cov_contract(PROBE, [
            Candidate(bad, 10_000, 0.0)]))
        assert _rules(got) == ["contract-eval"]
        assert "tolerance" in got[0].message

    def test_output_shape_drift_is_caught(self):
        got = check_contract(_cov_contract(PROBE, [
            Candidate(_cov_plan(), 10_000, 0.0)],
            expected=lambda p, plan: ((1, 1),) * 3))
        assert _rules(got) == ["contract-eval"]
        assert "expectation" in got[0].message

    def test_refused_probe_that_plans_is_a_finding(self):
        c = CONTRACTS["flash_decode"]._replace(
            probes=(), refused=({"b": 1, "h": 4, "kv": 4, "l": 300, "d": 64,
                                 "rk": 24, "rv": 40, "dtype": "float32"},))
        got = check_contract(c)
        assert _rules(got) == ["contract-eval"]
        assert "listed as refused" in got[0].message

    def test_refused_probe_is_reported_not_found(self):
        c = CONTRACTS["flash_decode"]._replace(probes=())
        refused = []
        assert check_contract(c, refused=refused) == []
        assert len(refused) == 2 and all("head dim 80" in r
                                         for r in refused)

    @pytest.mark.parametrize("kernel", sorted(CONTRACTS))
    def test_a_lattice_edit_past_the_launcher_fires(self, kernel,
                                                    monkeypatch):
        # every lattice offers one value its body refuses: the pass catches
        # it on the host (misaligned span / slice / depth, or a bad plan)
        c = CONTRACTS[kernel]
        probe = max(c.probes, key=lambda p: len(c.candidates(p)))
        cands = c.candidates(probe)
        p = cands[0].plan
        fields = {"cov_accum": {"splits": 2, "rows_per_split": 100},
                  "lowrank_matmul": {"splits_xv": 2, "depth_xv": 100},
                  "flash_attention": {"span": 100, "spans": 3},
                  "flash_decode": {"span": 100},
                  "grouped_matmul": {"d": 81}}[kernel]
        if kernel == "lowrank_matmul" and p.n == 0:
            pytest.skip("no x @ V")
        bad = replace(p, **fields)
        got = check_contract(c._replace(
            probes=(probe,), candidates=lambda q: cands + [
                Candidate(bad, cands[0].smem_bytes, 0.0)]))
        assert got and {"contract-alignment", "contract-eval"} & \
            set(_rules(got)), kernel


def test_wgmma_split_must_be_one_slice_a_block():
    # the wgmma body takes a split product only in WG_SLICE slices
    p = low.plan(77, 2048, 96, 256, torch.bfloat16)
    bad = replace(p, splits_xv=2, depth_xv=1024)
    c = CONTRACTS["lowrank_matmul"]
    got = check_contract(c._replace(
        probes=({"t": 77, "n": 2048, "k": 96, "m": 256,
                 "dtype": "bfloat16"},),
        candidates=lambda q: [Candidate(p, 132160, 0.0),
                              Candidate(bad, 132160, 0.0)]))
    assert any(f.rule == "contract-alignment" and "depth_xv=1024" in f.message
               for f in got)
