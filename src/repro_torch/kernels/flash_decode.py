"""Launcher of the CUDA latent-cache decode kernel (``csrc/flash_decode.cu``).

Replaces the Pallas TPU kernel
``src/repro/kernels/flash_decode.py::flash_decode`` (oracle
``src/repro/kernels/ref.py:82``): one decode step against the factorized
latent KV cache, keys up-projected (l_k @ U_k per KV head) and RoPE'd in the
kernel, values absorbed (the accumulator stays in (g, r_v) latent space and
U_v is applied in the epilogue), all arithmetic in fp32.  One block per
(slot, KV head) loops over the slot's live keys.  U_k and U_v are read in
their stored (r, KV·D) layout.

Bound on the card: the fp32 operations of the key up-projection,
2·Σ_b len_b·r_k·KV·D, dominate the bytes of the live latents and the two
U factors.  Callers go through ``kernels.ops.flash_decode``, which checks
the mixed dtypes and shapes; this module only launches.
"""

from __future__ import annotations

import torch

from repro_torch.kernels import build

DTYPES = {torch.float32: 0, torch.bfloat16: 1}

HEAD_DIMS = (16, 32, 64, 128)
KEY_TILE = 64
RANK_CHUNK = 32
MAX_SMEM = 232448   # bytes of shared memory one block may use on Hopper


def smem_bytes(h: int, kv: int, d: int, rv: int) -> int:
    """Shared memory of one block (mirrors ``smem_floats`` in the .cu)."""
    g = h // kv
    floats = (g * d + RANK_CHUNK * (KEY_TILE + 1) + RANK_CHUNK * d
              + KEY_TILE * (d + 1) + g * KEY_TILE + g * rv + 3 * g)
    return 4 * floats


def launch(q, lk, lv, uk, uv, lengths, cos, sin, out, *, rope: bool) -> None:
    """q, out (B, H, D); lk/lv (B, L, r); uk/uv (r, KV·D) fp32; lengths (B,)
    int32; cos/sin (L, D/2) fp32 — all checked by the wrapper."""
    b, h, d = q.shape
    l, rk = lk.shape[1], lk.shape[2]
    rv = lv.shape[2]
    kv = uk.shape[1] // d
    lib = build.library()
    stream = torch.cuda.current_stream(q.device).cuda_stream
    rc = lib.flash_decode_launch(
        q.data_ptr(), lk.data_ptr(), lv.data_ptr(), uk.data_ptr(),
        uv.data_ptr(), lengths.data_ptr(),
        cos.data_ptr() if rope else None, sin.data_ptr() if rope else None,
        out.data_ptr(), b, l, h, kv, d, rk, rv, int(rope), DTYPES[q.dtype],
        stream)
    build.check(rc, "flash_decode")
