"""The port's static dispatch check (``repro_torch.analysis``) against the
JAX package's (``repro.analysis``).

* On the JAX package's fixtures and snippets for the rules both share
  (``host-sync-loop``, ``print-hot`` outside traced bodies,
  ``bare-except``, ``allow-no-reason``), the port's checker gives the same
  (rule, line) findings as ``repro.analysis.dispatch``.
* torch's spellings of a host sync (``.tolist()``, ``.cpu()``,
  ``.numpy()``) fire on per-step device values in a loop; their clean
  twins do not.
* The allowlist: same line, the line above, a rule mismatch, ``*``, an
  empty reason.
* The CLI exits 1 on a seeded file, 0 on ``src/repro_torch/`` and 2 on a
  usage error; every marker in the port gives a reason, and deleting one
  brings its finding back.
"""

from __future__ import annotations

import torch_thread_cap  # noqa: F401  (thread caps under pytest-xdist)
import os
import pathlib
import subprocess
import sys
import textwrap

import pytest

import repro_torch.analysis as TA
from repro.analysis import dispatch as jdispatch
from repro_torch.analysis import dispatch
from repro_torch.analysis.findings import Allowlist, Finding, apply_allowlist

ROOT = pathlib.Path(__file__).resolve().parents[1]
FIXTURES = ROOT / "tests" / "fixtures" / "analysis"
PORT = ROOT / "src" / "repro_torch"
SHARED = set(dispatch.RULES)


def _pairs(findings):
    return sorted((f.rule, f.line) for f in findings)


def _jax_shared(findings):
    return _pairs(f for f in findings if f.rule in SHARED)


# (fixture, hot): the JAX package's fixtures for the shared rules; its
# print fixture only at hot=True (at hot=False its finding comes from the
# traced body, which the port does not have)
FIXTURE_CASES = [
    ("host_sync_loop_bad.py", None), ("host_sync_loop_ok.py", None),
    ("print_hot_bad.py", True), ("print_hot_ok.py", True),
    ("print_hot_ok.py", False), ("bare_except_bad.py", None),
    ("bare_except_ok.py", None),
]


@pytest.mark.parametrize("name,hot", FIXTURE_CASES,
                         ids=[f"{n}-{h}" for n, h in FIXTURE_CASES])
def test_fixtures_match_the_jax_checker(name, hot):
    path = str(FIXTURES / name)
    got = dispatch.check_file(path, hot=hot)
    want = jdispatch.check_file(path, hot=hot)
    assert _pairs(got) == _jax_shared(want)
    if name.endswith("_bad.py"):
        assert got


SNIPPETS = {
    "nested_loops": """
        def f(step, xs):
            for a in xs:
                for b in xs:
                    y = step(a, b)
                    print(float(y))
    """,
    "tuple_unpack": """
        def f(step, xs):
            t = 0.0
            for x in xs:
                (loss, aux), _ = step(x)
                t += float(loss) + aux.item()
            return t
    """,
    "host_values": """
        def f(xs, ys):
            s = 0.0
            for x in xs:
                s += float(x) + float(len(ys)) + float("nan")
            return s
    """,
    "marker_above": """
        def f(step, xs):
            for x in xs:
                # repro-check: allow[host-sync-loop] — parity loop
                v = float(step(x))
            return v
    """,
    "marker_wrong_rule": """
        def f(step, xs):
            for x in xs:
                v = float(step(x))  # repro-check: allow[bare-except] — no
            return v
    """,
    "marker_no_reason": """
        def f(step, xs):
            for x in xs:
                v = float(step(x))  # repro-check: allow[host-sync-loop]
            return v
    """,
    "star": """
        def f(step, xs):
            for x in xs:
                try:
                    v = float(step(x))  # repro-check: allow[*] — generated
                except BaseException:
                    raise
    """,
    "nested_def_in_loop": """
        def f(step, xs):
            for x in xs:
                def g():
                    return float(step(x))
                g()
    """,
    "excepts": """
        def f(fn):
            try:
                fn()
            except:
                pass
            try:
                fn()
            except (OSError, KeyError):
                pass
            try:
                fn()
            except builtins.Exception:
                pass
    """,
    "print_in_loop": """
        def f(step, xs):
            while xs:
                print(step(xs.pop()).item())
    """,
}


@pytest.mark.parametrize("name", sorted(SNIPPETS))
@pytest.mark.parametrize("hot", [True, False])
def test_snippets_match_the_jax_checker(name, hot):
    src = textwrap.dedent(SNIPPETS[name])
    got = dispatch.check_source("snippet.py", src, hot=hot)
    want = jdispatch.check_source("snippet.py", src, hot=hot)
    assert _pairs(got) == _jax_shared(want)


TORCH_BAD = """
    def drain(model, batches, cache):
        out = []
        for b in batches:
            logits = model(b)
            out.append(logits.argmax(-1).tolist())      # .tolist() of a call
            out.append(logits.cpu())                    # .cpu() of a name
            out.append(model(b).numpy())                # .numpy() of a call
            out.append(logits[0].cpu().numpy())         # subscript, chained
        while cache:
            ids = cache.pop().nonzero()
            out.append(ids.tolist())                    # while loop
        return out
"""

TORCH_OK = """
    def drain(model, batches, stack):
        outs = [model(b) for b in batches]
        host = stack(outs).cpu().numpy()      # one transfer, after the loop
        lens = batches.lengths()
        for t in outs:                        # loop variable: not a call
            t.tolist()
        for n in lens.tolist():               # the loop's own bound
            host[n] = 0
        for b in batches:
            x = model(b)
            x.float().sum(0)                  # stays on the device
            b.numpy()                         # b comes from no call
        return host
"""


def test_torch_spellings_fire():
    got = dispatch.check_source("m.py", textwrap.dedent(TORCH_BAD),
                                hot=False)
    assert [f.rule for f in got] == ["host-sync-loop"] * 5
    assert [f.line for f in got] == [6, 7, 8, 9, 12]
    messages = " ".join(f.message for f in got)
    for spelling in (".tolist()", ".cpu()", ".numpy()"):
        assert spelling in messages


def test_torch_spellings_clean_twin():
    assert dispatch.check_source("m.py", textwrap.dedent(TORCH_OK),
                                 hot=False) == []


def test_jax_spellings_without_jit_fire_alike():
    """float() / .item() of a call's result: the JAX rule, unchanged."""
    src = textwrap.dedent("""
        def f(step, xs):
            for x in xs:
                a = float(step(x))
                b = step(x).item()
    """)
    assert _pairs(dispatch.check_source("m.py", src)) == \
        _pairs(jdispatch.check_source("m.py", src)) == \
        [("host-sync-loop", 4), ("host-sync-loop", 5)]


def test_hot_inferred_from_the_port_path():
    assert dispatch._is_hot("src/repro_torch/core/zoo.py")
    assert dispatch._is_hot("src/repro_torch/kernels/ops.py")
    assert dispatch._is_hot("src/repro_torch/checkpoint/manager.py")
    assert not dispatch._is_hot("src/repro_torch/launch/train.py")
    assert not dispatch._is_hot("src/repro_torch/analysis/__main__.py")
    assert not dispatch._is_hot("src/repro/core/zoo.py")


def test_syntax_error_reported_not_raised():
    got = dispatch.check_source("f.py", "def broken(:\n")
    assert [f.rule for f in got] == ["syntax-error"]


# ---------------------------------------------------------------------------
# the allowlist


def test_marker_on_line_and_line_above():
    src = ("x = 1  # repro-check: allow[some-rule] — reason\n"
           "y = 2\n"
           "# repro-check: allow[other-rule] — reason\n"
           "z = 3\n")
    allow = Allowlist("f.py", src)
    assert allow.allows("some-rule", 1)
    assert allow.allows("some-rule", 2)
    assert allow.allows("other-rule", 4)
    assert not allow.allows("some-rule", 3)
    assert not allow.allows("other-rule", 1)
    assert not allow.allows("other-rule", 5)


def test_rule_must_match_unless_star():
    assert Allowlist("f.py", "x  # repro-check: allow[*] — generated\n"
                     ).allows("anything", 1)
    assert not Allowlist("f.py", "x  # repro-check: allow[a-rule] — r\n"
                         ).allows("b-rule", 1)


@pytest.mark.parametrize("marker", [
    "x = 1  # repro-check: allow[r]\n",
    "x = 1  # repro-check: allow[r] —   \n",
    "x = 1  # repro-check: allow[r]:\n",
])
def test_empty_reason_is_a_finding_and_no_suppression(marker):
    allow = Allowlist("f.py", marker)
    assert not allow.allows("r", 1)
    kept = apply_allowlist([Finding("r", "f.py", 1, "m")], allow)
    assert sorted(f.rule for f in kept) == ["allow-no-reason", "r"]


@pytest.mark.parametrize("sep", ["-", "—", ":"])
def test_separators_match_the_jax_allowlist(sep):
    from repro.analysis.findings import Allowlist as JAllowlist
    src = f"v = 1  # repro-check: allow[host-sync-loop] {sep} why\n"
    assert Allowlist("f.py", src).allows("host-sync-loop", 1)
    assert JAllowlist("f.py", src).allows("host-sync-loop", 1)


# ---------------------------------------------------------------------------
# the port is clean, and its markers are real


def test_port_is_clean():
    findings = TA.run()
    assert findings == [], "\n".join(f.format() for f in findings)
    assert TA.default_root() == str(PORT)
    assert str(PORT / "core" / "zoo.py") in TA.iter_py_files([str(PORT)])


def test_every_marker_in_the_port_gives_a_reason():
    from repro_torch.analysis.findings import _ALLOW_RE
    files = [p for p in TA.iter_py_files([str(PORT)])
             if "/analysis/" not in p]
    n = 0
    for path in files:
        text = pathlib.Path(path).read_text()
        n += sum(bool(_ALLOW_RE.search(line)) for line in text.splitlines())
        assert Allowlist(path, text).malformed == [], path
    assert n == 6


@pytest.mark.parametrize("rel", ["core/zoo.py", "core/pipeline.py",
                                 "core/refine.py", "launch/serve.py",
                                 "launch/train.py"])
def test_markers_are_not_silence(rel):
    """Deleting a file's markers brings its findings back."""
    path = PORT / rel
    text = path.read_text()
    assert "repro-check: allow[host-sync-loop]" in text
    stripped = text.replace("repro-check: allow[host-sync-loop]", "was-allow")
    got = dispatch.check_source(str(path), stripped)
    assert got and {f.rule for f in got} == {"host-sync-loop"}


def _cli(*args):
    env = dict(os.environ)
    env["PYTHONPATH"] = str(ROOT / "src") + os.pathsep \
        + env.get("PYTHONPATH", "")
    return subprocess.run([sys.executable, "-m", "repro_torch.analysis",
                           *args], capture_output=True, text=True, env=env,
                          timeout=120)


def test_cli_exits_1_on_a_seeded_file(tmp_path):
    bad = tmp_path / "seeded.py"
    bad.write_text(textwrap.dedent(TORCH_BAD))
    proc = _cli(str(bad))
    assert proc.returncode == 1
    assert proc.stdout.count("[host-sync-loop]") == 5
    assert "5 finding(s)" in proc.stderr


def test_cli_exits_0_on_the_port():
    for args in ((), (str(PORT),)):
        proc = _cli(*args)
        assert proc.returncode == 0, proc.stdout + proc.stderr
        assert "clean" in proc.stderr and proc.stdout == ""


def test_cli_exits_2_on_a_usage_error():
    proc = _cli("--no-such-pass")
    assert proc.returncode == 2
    assert "usage" in proc.stderr
