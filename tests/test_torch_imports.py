"""The port stands alone: no jax, nothing of ``repro``, CUDA by default."""

from __future__ import annotations

import ast
import os
import pathlib
import subprocess
import sys

import pytest
import torch

ROOT = pathlib.Path(__file__).resolve().parents[1]
PORT = ROOT / "src" / "repro_torch"


def _imported_modules(path: pathlib.Path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name
        elif isinstance(node, ast.ImportFrom) and node.module:
            yield node.module


def _port_files():
    files = sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"]
    return [f for f in files if f.exists()]


@pytest.mark.parametrize("path", _port_files(),
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_or_repro_imports(path):
    bad = [m for m in _imported_modules(path)
           if m == "jax" or m.startswith("jax.") or m == "repro"
           or m.startswith("repro.")]
    assert bad == [], f"{path} imports {bad}"


def test_import_and_compress_leave_jax_unloaded():
    script = (
        "import sys, numpy as np\n"
        "import repro_torch\n"
        "from repro_torch import configs\n"
        "from repro_torch.models import model as M\n"
        "cfg = configs.get_smoke_config('llama-7b').replace("
        "dtype='float32', num_layers=1)\n"
        "p = M.init_params(cfg, 0, device='cpu')\n"
        "toks = np.random.default_rng(0).integers(0, 256, (2, 16))\n"
        "c, r = repro_torch.compress_model(p, cfg, {'tokens': toks}, "
        "repro_torch.CompressConfig(ratio=0.6, microbatch=2, "
        "refine_epochs=1, calib_mode='fused'), device='cpu')\n"
        "assert 'u' in c['stages'][0][0]['attn']['wq']\n"
        "print('jax' in sys.modules, 'repro' in sys.modules)\n")
    env = dict(os.environ)
    env["PYTHONPATH"] = str(ROOT / "src")
    out = subprocess.run([sys.executable, "-c", script], env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.split() == ["False", "False"]


def test_compress_without_device_needs_cuda():
    if torch.cuda.is_available():
        pytest.skip("this machine has CUDA: the default device is valid")
    import repro_torch
    from repro_torch import configs
    cfg = configs.get_smoke_config("llama-7b").replace(dtype="float32")
    with pytest.raises(RuntimeError, match="CUDA"):
        repro_torch.compress_model({}, cfg, {"tokens": [[0, 1]]},
                                   repro_torch.CompressConfig())


def test_unported_modes_raise():
    import repro_torch
    from repro_torch import configs
    cfg = configs.get_smoke_config("llama-7b").replace(dtype="float32")
    for kw in ({"calib_mode": "hybrid"}, {"rank_mode": "adaptive"},
               {"calib_mesh": "auto"}):
        with pytest.raises(NotImplementedError):
            repro_torch.compress_model({}, cfg, {"tokens": [[0, 1]]},
                                       repro_torch.CompressConfig(**kw),
                                       device="cpu")
