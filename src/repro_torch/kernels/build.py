"""Build and bind the hand-written CUDA kernels (``src/repro_torch/csrc/*.cu``).

Route: ``nvcc`` straight to a shared library with a plain C interface, loaded
with ``ctypes`` — no PyTorch headers, so a build takes seconds.  Every source
compiles in its own ``nvcc`` process, all started together, then one link
step makes ``librepro_torch_kernels.so``.  ``csrc/hopper.cuh`` holds the
TMA / barrier / wgmma helpers the wgmma kernels share.

The build happens at first use (the first CUDA launch), never at import, into
``<repo>/build/repro_torch/<hash>/`` where ``<hash>`` covers the sources and
the flags, so an edited kernel rebuilds and an unchanged one is reused.  A
missing ``nvcc`` or a failed compile raises ``RuntimeError`` carrying the
compiler's output: nothing falls back to the plain PyTorch versions.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import pathlib
import shutil
import subprocess
import tempfile
import threading
from typing import List, Optional

CSRC = pathlib.Path(__file__).resolve().parents[1] / "csrc"
BUILD_ROOT = pathlib.Path(__file__).resolve().parents[3] / "build" / "repro_torch"
LIB_NAME = "librepro_torch_kernels.so"
FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
         "-Xcompiler", "-fPIC"]

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
_L = ctypes.c_longlong
# C signatures of the launchers (every pointer and the stream as c_void_p,
# floats as c_float, 64-bit sizes as c_longlong)
SIGNATURES = {
    "cov_accum_launch": [_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I,
                         _I, _P],
    "lowrank_matmul_launch": [_P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I,
                              _I, _I, _I, _I, _I, _I, _I, _I, _I, _P],
    "flash_attention_launch": [_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I,
                               _I, _I, _I, _F, _F, _I, _I, _I, _I, _I, _I,
                               _P, _P],
    "flash_decode_launch": [_P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _L, _I,
                            _I, _I, _I, _I, _I, _I, _I, _I, _I, _I, _I,
                            _P],
    "grouped_matmul_launch": [_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _I,
                              _I, _I, _I, _I, _P],
}

_LOCK = threading.Lock()
_LIB: Optional[ctypes.CDLL] = None


def sources() -> List[pathlib.Path]:
    return sorted(CSRC.glob("*.cu"))


def headers() -> List[pathlib.Path]:
    """The headers the sources include (``hopper.cuh``)."""
    return sorted(CSRC.glob("*.cuh"))


def source_hash() -> str:
    h = hashlib.sha256(" ".join(FLAGS).encode())
    for src in sources() + headers():
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return h.hexdigest()[:16]


def library_path() -> pathlib.Path:
    return BUILD_ROOT / source_hash() / LIB_NAME


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found is None and os.path.exists("/usr/local/cuda/bin/nvcc"):
        found = "/usr/local/cuda/bin/nvcc"
    if found is None:
        raise RuntimeError(
            "nvcc not found: the repro_torch CUDA kernels are built at first "
            "use and need the CUDA toolkit (PATH or /usr/local/cuda/bin)")
    return found


def build() -> pathlib.Path:
    """Compile every source in parallel and link the shared library; return
    its path.  Reuses an existing build of the same sources and flags.  The
    compiler's output (``-Xptxas -v``: registers, shared memory, spills per
    kernel) is kept beside the library as ``build.log``."""
    out = library_path()
    if out.exists():
        return out
    nvcc = _nvcc()
    BUILD_ROOT.mkdir(parents=True, exist_ok=True)
    work = pathlib.Path(tempfile.mkdtemp(prefix="build-", dir=BUILD_ROOT))
    try:
        procs = []
        for src in sources():
            obj = work / (src.stem + ".o")
            cmd = [nvcc, *FLAGS, "-Xptxas", "-v", "-c", str(src), "-o",
                   str(obj)]
            procs.append((cmd, obj, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True)))
        log = []
        failed = []
        for cmd, _, proc in procs:
            text, _ = proc.communicate()
            log.append("$ " + " ".join(cmd) + "\n" + text)
            if proc.returncode != 0:
                failed.append(cmd[-3])
        if failed:
            raise RuntimeError(f"nvcc failed on {failed}:\n" + "\n".join(log))
        lib = work / LIB_NAME
        cmd = [nvcc, *FLAGS, "-shared", "-o", str(lib),
               *[str(obj) for _, obj, _ in procs]]
        proc = subprocess.run(cmd, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
        log.append("$ " + " ".join(cmd) + "\n" + proc.stdout)
        if proc.returncode != 0:
            raise RuntimeError("nvcc link failed:\n" + "\n".join(log))
        out.parent.mkdir(parents=True, exist_ok=True)
        (out.parent / "build.log").write_text("\n".join(log))
        os.replace(lib, out)
    finally:
        shutil.rmtree(work, ignore_errors=True)
    return out


def build_log() -> str:
    path = library_path().parent / "build.log"
    return path.read_text() if path.exists() else ""


def library() -> ctypes.CDLL:
    """The loaded kernel library, built on first call."""
    global _LIB
    with _LOCK:
        if _LIB is None:
            lib = ctypes.CDLL(str(build()))
            for name, argtypes in SIGNATURES.items():
                fn = getattr(lib, name)
                fn.argtypes = argtypes
                fn.restype = ctypes.c_int
            _LIB = lib
    return _LIB


def check(rc: int, kernel: str) -> None:
    """Raise on a non-zero ``cudaGetLastError()`` code from a launcher."""
    if rc != 0:
        raise RuntimeError(f"{kernel}: CUDA launch failed with cudaError {rc}")
