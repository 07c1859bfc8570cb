"""Factorized parameter structures: the compressed model as a deployment
target.

Counterpart of ``src/repro/core/factorized.py``.  ``factorize_params``
swaps every compressible linear {"w"} for zero-filled {"v", "u"} factors at
the rank the compression ratio implies: the buffers a compressed checkpoint
is loaded into, and (on the ``"meta"`` device) the compressed model's
shapes without allocating them.  The real factors come from
``core.pipeline.compress_model``.  A weight-shared block (zamba2's) is
factorized once, in ``params["shared"]``; an encoder's stages (whisper's)
are factorized as the decoder's are.
"""

from __future__ import annotations

from typing import Any, Optional

import torch

from repro_torch.core import ranks as R
from repro_torch.core.pipeline import get_path, linear_specs, set_path
from repro_torch.device import resolve_device
from repro_torch.models import blocks as B
from repro_torch.tree import tree_map


def _factorize_leaf(leaf, ratio: float, remap: bool, multiple: int, dev):
    w = leaf["w"]
    n, m = w.shape[-2], w.shape[-1]
    k = R.rank_for_ratio(m, n, ratio, remap=remap, multiple=multiple)
    lead = tuple(w.shape[:-2])
    new = {kk: vv for kk, vv in leaf.items() if kk != "w"}
    new["v"] = torch.zeros(lead + (n, k), dtype=w.dtype, device=dev)
    new["u"] = torch.zeros(lead + (k, m), dtype=w.dtype, device=dev)
    return new


def factorize_params(params, cfg, *, ratio: Optional[float] = None,
                     remap: Optional[bool] = None, rank_multiple: int = 128,
                     device=None) -> Any:
    """Structure transform: dense params -> AA-SVD factorized params.

    The factor buffers are zeros on ``device`` (None: the card; ``"cpu"``;
    ``"meta"`` for shapes alone); every other leaf is kept as it is.  The
    caller's containers are never modified."""
    ratio = cfg.compress_ratio if ratio is None else ratio
    remap = cfg.compress_remap if remap is None else remap
    if ratio >= 1.0:
        return params
    dev = resolve_device(device)
    params = tree_map(lambda x: x, params)  # fresh containers

    def factorize(kind, p):
        for spec in linear_specs(kind, cfg):
            leaf = get_path(p, spec.path)
            if "w" in leaf:
                set_path(p, spec.path, _factorize_leaf(leaf, ratio, remap,
                                                       rank_multiple, dev))

    def do_stages(stages, stage_params):
        for st, sp in zip(stages, stage_params):
            for ki, kind in enumerate(st.kinds):
                # a weight-shared kind's stage slots are None: its params
                # live in params["shared"]
                if kind not in B.SHARED_KINDS:
                    factorize(kind, sp[ki])

    do_stages(B.stage_program(cfg), params["stages"])
    if "encoder" in params:
        do_stages(B.encoder_stages(cfg), params["encoder"]["stages"])
    for kind, p in params.get("shared", {}).items():
        factorize(kind, p)
    return params
