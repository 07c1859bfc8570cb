"""The port stands alone: no jax, nothing of ``repro``, CUDA by default."""

from __future__ import annotations

import torch_thread_cap  # noqa: F401  (thread caps under pytest-xdist)
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


# the training path's modules: each must be among the files checked above
TRAINER_MODULES = ("repro_torch.data", "repro_torch.data.synthetic",
                   "repro_torch.optim.compression", "repro_torch.launch.steps",
                   "repro_torch.launch.train")


@pytest.mark.parametrize("module", TRAINER_MODULES)
def test_trainer_modules_are_checked(module):
    rel = pathlib.Path(*module.split("."))
    path = (ROOT / "src" / rel).with_suffix(".py")
    if not path.exists():
        path = ROOT / "src" / rel / "__init__.py"
    assert path in _port_files()


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
    # hybrid calibration and adaptive ranks are ported: only calib_mesh
    # (data-parallel collection) still raises
    import repro_torch
    from repro_torch import configs
    cfg = configs.get_smoke_config("llama-7b").replace(dtype="float32")
    with pytest.raises(NotImplementedError, match="calib_mesh"):
        repro_torch.compress_model({}, cfg, {"tokens": [[0, 1]]},
                                   repro_torch.CompressConfig(
                                       calib_mesh="auto"),
                                   device="cpu")
    for kw in ({"calib_mode": "hybrid"}, {"rank_mode": "adaptive"},
               {"calib_mode": "hybrid", "replay_taps": "auto"}):
        # accepted: the empty param tree fails later, never as unported
        with pytest.raises(Exception) as err:
            repro_torch.compress_model({}, cfg, {"tokens": [[0, 1]]},
                                       repro_torch.CompressConfig(**kw),
                                       device="cpu")
        assert not isinstance(err.value, NotImplementedError), kw


def test_adaptive_compress_save_restore_leave_jax_unloaded(tmp_path):
    script = (
        "import sys, numpy as np, torch\n"
        "import repro_torch\n"
        "from repro_torch import configs\n"
        "from repro_torch.checkpoint import CheckpointManager\n"
        "from repro_torch.models import model as M\n"
        "cfg = configs.get_smoke_config('llama-7b').replace("
        "dtype='float32', num_layers=2)\n"
        "p = M.init_params(cfg, 0, device='cpu')\n"
        "toks = np.random.default_rng(0).integers(0, 256, (4, 16))\n"
        "c, r = repro_torch.compress_model(p, cfg, {'tokens': toks}, "
        "repro_torch.CompressConfig(ratio=0.6, microbatch=2, "
        "refine_epochs=1, calib_mode='hybrid', replay_taps='auto', "
        "rank_mode='adaptive'), device='cpu')\n"
        "assert r['calibration']['rank_mode']['mode'] == 'adaptive'\n"
        "c['half'] = torch.ones(3, dtype=torch.bfloat16)\n"
        f"mgr = CheckpointManager({str(tmp_path)!r})\n"
        "mgr.save(0, c, reslice_banks=True)\n"
        "mgr.wait()\n"
        "_, back, _ = mgr.restore_tree(0, device='cpu')\n"
        "assert torch.equal(back['half'], c['half'])\n"
        "assert torch.equal(back['stages'][0][0]['attn']['wq']['u'], "
        "c['stages'][0][0]['attn']['wq']['u'])\n"
        "print(*(m in sys.modules for m in ('jax', 'repro', "
        "'ml_dtypes')))\n")
    env = dict(os.environ)
    env["PYTHONPATH"] = str(ROOT / "src")
    out = subprocess.run([sys.executable, "-c", script], env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.split() == ["False", "False", "False"]


def test_train_leaves_jax_unloaded(tmp_path):
    # importing the trainer and training two steps on the CPU loads
    # neither jax nor the JAX package
    script = (
        "import sys\n"
        f"import {', '.join(TRAINER_MODULES)}\n"
        "from repro_torch import configs\n"
        "from repro_torch.launch import train as T\n"
        "cfg = configs.get_smoke_config('qwen3-0.6b').replace("
        "dtype='float32')\n"
        "state, info = T.train(cfg, steps=2, batch=2, seq_len=8, "
        f"ckpt_dir={str(tmp_path)!r}, device='cpu')\n"
        "assert info['step'] == 2\n"
        "print('jax' in sys.modules, 'repro' in sys.modules)\n")
    env = dict(os.environ)
    env["PYTHONPATH"] = str(ROOT / "src")
    out = subprocess.run([sys.executable, "-c", script], env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.split()[-2:] == ["False", "False"]


# the zoo harness, the static checker, the autotuner and its contracts: each
# among the files checked above
ZOO_ANALYSIS_MODULES = ("repro_torch.core.zoo", "repro_torch.analysis",
                        "repro_torch.analysis.dispatch",
                        "repro_torch.analysis.findings",
                        "repro_torch.analysis.__main__",
                        "repro_torch.analysis.contracts",
                        "repro_torch.kernels.autotune",
                        "repro_torch.kernels.contracts")


@pytest.mark.parametrize("module", ZOO_ANALYSIS_MODULES)
def test_zoo_and_analysis_modules_are_checked(module):
    rel = pathlib.Path(*module.split("."))
    path = (ROOT / "src" / rel).with_suffix(".py")
    if not path.exists():
        path = ROOT / "src" / rel / "__init__.py"
    assert path in _port_files()


def _run(script):
    env = dict(os.environ)
    env["PYTHONPATH"] = str(ROOT / "src")
    out = subprocess.run([sys.executable, "-c", script], env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    return out.stdout.split()


def test_analysis_leaves_torch_unloaded():
    # the checker needs the standard library alone: the package root
    # imports no torch
    got = _run(
        "import sys\n"
        "import repro_torch, repro_torch.analysis\n"
        "from repro_torch.analysis import __main__, dispatch, findings\n"
        "assert repro_torch.analysis.run(kernel_contracts=False) == []\n"
        "print(*(m in sys.modules for m in ('torch', 'numpy', 'jax', "
        "'repro')))\n")
    assert got == ["False", "False", "False", "False"]


def test_zoo_roundtrip_leaves_jax_unloaded(tmp_path):
    got = _run(
        "import sys\n"
        "from repro_torch.core import zoo\n"
        f"rec, _ = zoo.roundtrip('llama-7b', {str(tmp_path)!r}, "
        "device='cpu')\n"
        "assert rec['bit_parity'] and rec['token_match']\n"
        "print('jax' in sys.modules, 'repro' in sys.modules)\n")
    assert got[-2:] == ["False", "False"]


def _fp32_covered(path: pathlib.Path) -> bool:
    """Whether the module imports ``repro_torch._fp32`` itself or sits in a
    subpackage whose ``__init__`` does."""
    def imports_fp32(p):
        return p.exists() and "repro_torch._fp32" in set(_imported_modules(p))
    return imports_fp32(path) or (path.parent != PORT and imports_fp32(
        path.parent / "__init__.py"))


def _torch_modules():
    return [p for p in sorted(PORT.rglob("*.py")) if p.name != "_fp32.py"
            and "torch" in {m.split(".")[0] for m in _imported_modules(p)}]


@pytest.mark.parametrize("path", _torch_modules(),
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_every_torch_module_turns_tf32_off_first(path):
    assert _fp32_covered(path), path


@pytest.mark.parametrize("module", ["repro_torch.tree",
                                    "repro_torch.kernels.ref",
                                    "repro_torch.models.layers"])
def test_importing_a_module_that_computes_turns_tf32_off(module):
    got = _run(
        f"import {module}, torch\n"
        "print(torch.backends.cuda.matmul.allow_tf32, "
        "torch.backends.cudnn.allow_tf32)\n")
    assert got == ["False", "False"]


@pytest.mark.parametrize("module", ["repro_torch.kernels.autotune",
                                    "repro_torch.kernels.contracts",
                                    "repro_torch.analysis.contracts"])
def test_tuner_and_contracts_import_neither_jax_nor_repro(module):
    got = _run(
        "import sys\n"
        f"import {module}\n"
        "print(*(m in sys.modules for m in ('jax', 'repro')))\n")
    assert got == ["False", "False"]


def test_analysis_root_and_contract_module_stay_torch_free():
    # importing the contract pass loads no torch: it imports it inside its
    # own function, as the dispatch pass needs none
    got = _run(
        "import sys\n"
        "import repro_torch.analysis, repro_torch.analysis.contracts\n"
        "from repro_torch.analysis import __main__\n"
        "print('torch' in sys.modules)\n")
    assert got == ["False"]


def test_contract_pass_loads_torch_but_not_jax():
    got = _run(
        "import sys\n"
        "from repro_torch.analysis import run\n"
        "assert run() == []\n"
        "print(*(m in sys.modules for m in ('torch', 'jax', 'repro')))\n")
    assert got == ["True", "False", "False"]
