"""AST dispatch-hygiene lint of the port.

Counterpart of ``src/repro/analysis/dispatch.py``, with the rules that mean
something for eager PyTorch:

* ``host-sync-loop`` — a blocking host read of a device value inside a
  Python ``for`` / ``while`` loop: one host sync per step.  The JAX
  package's spellings, ``float()`` and ``.item()``, plus torch's own:
  ``.tolist()``, ``.cpu()`` and ``.numpy()``.  The value counts as a
  per-step device value when it is a call's result, or a name bound from a
  call inside the loop (a subscript of either too).  Intentional
  measurement, parity or reference loops carry an inline
  ``repro-check: allow[host-sync-loop]`` justification.
* ``print-hot`` — ``print`` in library code (``core`` / ``kernels`` /
  ``models`` / ``optim`` / ``distributed`` / ``checkpoint`` under
  ``repro_torch/``).  Library progress goes through ``logging``;
  ``launch`` CLI tools keep their stdout.
* ``bare-except`` — ``except:`` / ``except Exception:`` without an inline
  justification; failures must be narrowed or explicitly excused.  A
  blanket handler on the port's path is how a fallback that hides the
  device or a kernel would get in.
* ``allow-no-reason`` — an allow marker that gives no reason
  (``analysis.findings``).

The JAX package's other three rules have no counterpart here: the port has
no ``jax.jit`` and no traced bodies (``host-sync-traced`` and the traced
half of ``print-hot``), no ``lru_cache``d jit factories whose cache key
could omit ambient config (``jit-cache-key``), and no buffer donation
(``donated-reuse``).

The pass is intra-module and needs nothing but the standard library.
"""

from __future__ import annotations

import ast
from typing import Dict, List, Optional, Set

from repro_torch.analysis.findings import (Allowlist, Finding,
                                           apply_allowlist)

RULES: Dict[str, str] = {
    "host-sync-loop": "per-step host sync (float/.item/.tolist/.cpu/.numpy "
                      "of a device value) inside a Python loop",
    "print-hot": "print() in library code",
    "bare-except": "bare or blanket except without justification",
    "allow-no-reason": "allowlist marker without a justification",
}

# packages whose modules count as library "hot path" for print-hot
HOT_PACKAGE_MARKERS = ("/core/", "/kernels/", "/models/", "/optim/",
                       "/distributed/", "/checkpoint/")

# zero-argument methods that copy a tensor to the host and wait for it
_SYNC_METHODS = ("item", "tolist", "cpu", "numpy")

_SCOPES = (ast.FunctionDef, ast.AsyncFunctionDef, ast.Lambda)


def _last_name(node: ast.AST) -> Optional[str]:
    if isinstance(node, ast.Attribute):
        return node.attr
    if isinstance(node, ast.Name):
        return node.id
    if isinstance(node, ast.Call):
        return _last_name(node.func)
    return None


def _loop_device_names(loop: ast.AST) -> Set[str]:
    """Names bound from call results within the loop body (any tuple
    nesting): candidates for per-step device values."""
    names: Set[str] = set()
    for node in ast.walk(loop):
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            continue
        if isinstance(node, ast.Assign):
            has_call = any(isinstance(n, ast.Call)
                           for n in ast.walk(node.value))
            if not has_call:
                continue
            for tgt in node.targets:
                for leaf in ast.walk(tgt):
                    if isinstance(leaf, ast.Name):
                        names.add(leaf.id)
    return names


def _sync_target(node: ast.Call):
    """(label, the value synced) of a host-sync spelling, else None."""
    func = node.func
    if isinstance(func, ast.Name) and func.id == "float" and node.args:
        return "float()", node.args[0]
    if isinstance(func, ast.Attribute) and func.attr in _SYNC_METHODS \
            and not node.args:
        return f".{func.attr}()", func.value
    return None


def _check_loops(tree: ast.AST, path: str, out: List[Finding]) -> None:
    for loop in ast.walk(tree):
        if not isinstance(loop, (ast.For, ast.While)):
            continue
        device_names = _loop_device_names(loop)
        for node in ast.walk(loop):
            if isinstance(node, _SCOPES) or not isinstance(node, ast.Call):
                continue
            hit = _sync_target(node)
            if hit is None:
                continue
            what, target = hit
            if isinstance(target, ast.Subscript):
                target = target.value
            synced = isinstance(target, ast.Call) or (
                isinstance(target, ast.Name) and target.id in device_names)
            if synced:
                out.append(Finding(
                    "host-sync-loop", path, node.lineno,
                    f"{what} on a per-step device value inside a loop — "
                    "one blocking sync per iteration; keep the values on "
                    "the device or batch the transfer"))


def _check_prints_and_excepts(tree: ast.AST, path: str, hot: bool,
                              out: List[Finding]) -> None:
    for node in ast.walk(tree):
        if hot and isinstance(node, ast.Call) \
                and isinstance(node.func, ast.Name) \
                and node.func.id == "print":
            out.append(Finding(
                "print-hot", path, node.lineno,
                "print() in library code — route through logging "
                "(logger per module) so large runs can silence it"))
        elif isinstance(node, ast.ExceptHandler):
            if node.type is None:
                out.append(Finding(
                    "bare-except", path, node.lineno,
                    "bare except: catches everything including "
                    "KeyboardInterrupt — name the exceptions"))
            elif _last_name(node.type) in ("Exception", "BaseException"):
                out.append(Finding(
                    "bare-except", path, node.lineno,
                    f"except {_last_name(node.type)}: blanket handler — "
                    "narrow it or justify inline"))


def _is_hot(path: str) -> bool:
    norm = path.replace("\\", "/")
    return "/repro_torch/" in norm and any(m in norm
                                           for m in HOT_PACKAGE_MARKERS)


def check_source(path: str, source: str, *,
                 hot: Optional[bool] = None) -> List[Finding]:
    """All dispatch-hygiene findings for one module's source, allowlist
    applied.  ``hot`` forces/suppresses ``print-hot`` (None = infer from
    the path's package)."""
    try:
        tree = ast.parse(source)
    except SyntaxError as e:
        return [Finding("syntax-error", path, e.lineno or 0, str(e.msg))]
    findings: List[Finding] = []
    _check_loops(tree, path, findings)
    _check_prints_and_excepts(tree, path, _is_hot(path) if hot is None
                              else hot, findings)
    # two spellings on one line (``x.cpu().numpy()``) are one finding
    seen, unique = set(), []
    for f in findings:
        if (f.rule, f.line) not in seen:
            seen.add((f.rule, f.line))
            unique.append(f)
    unique.sort(key=lambda f: (f.line, f.rule))
    return apply_allowlist(unique, Allowlist(path, source))


def check_file(path: str, *, hot: Optional[bool] = None) -> List[Finding]:
    with open(path, encoding="utf-8") as f:
        return check_source(path, f.read(), hot=hot)
