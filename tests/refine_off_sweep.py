"""The closed-form solves' map gaps unit by unit, with refinement off.

How far two compressions of one smoke model apart are, unit by unit, when
each unit is only solved (``refine=False``): the port on the CPU at one
thread against the port at every core, and the port against the JAX
package, on one set of numpy-made tokens and the port's seeded dense params
(``init_params(cfg, 0)``, bridged to the JAX package): the model and tokens
of ``chip_smoke.py``'s ``phase_refine_off``, which compares the card with
the CPU.  For each unit: the worst relative Frobenius gap of its
composed maps ``v @ u`` plainly, and on the stream its solve saw
(||X′ ΔW|| / ||X′ W||, X′ᵀX′ from the port's ``debug_covs`` report), with
the worst condition number of its X′ᵀX′.

``tests/test_torch_sliding.py`` imports ``unit_gaps``.  As a script it
prints the sweep's table (under a minute on 8 cores)::

    PYTHONPATH=src python tests/refine_off_sweep.py [--arch gemma3-1b]
        [--tokens 8 32]
"""

from __future__ import annotations

import argparse
import json
import time

import numpy as np
import torch

RECIPE = dict(ratio=0.6, rank_multiple=1, microbatch=2, calib_mode="fused",
              refine=False, refine_epochs=0, debug_covs=True)


def unit_gaps(cfg, comp_a, comp_b, report):
    """{unit: (plain, shifted, condition number)} over every compressed
    linear of two port param trees of one model, in solve order; ``report``
    a ``debug_covs`` report of a run of that model (the X′ᵀX′ each solve
    saw)."""
    from repro_torch.core import pipeline as TP

    covs = {u["name"]: u.get("covs", {}) for u in report["units"]}
    out = {}
    for ua, ub in zip(TP.unit_iterator(comp_a, cfg),
                      TP.unit_iterator(comp_b, cfg)):
        if ua.params is None:
            continue
        worst = [0.0, 0.0, 0.0]
        for spec in TP.linear_specs(ua.kind, cfg):
            la = TP.get_path(ua.params, spec.path)
            lb = TP.get_path(ub.params, spec.path)
            ga = la["v"].double() @ la["u"].double()
            gb = lb["v"].double() @ lb["u"].double()
            xpxp = covs[ua.name][spec.tap]["xpxp"].double()
            lam, q = torch.linalg.eigh(xpxp)
            half = q * lam.clamp(min=0.0).sqrt()
            dw = ga - gb
            plain = float(dw.norm() / gb.norm())
            shifted = float((half.T @ dw).norm() / (half.T @ gb).norm())
            cond = float(lam[-1] / lam[0].clamp(min=1e-300))
            worst = [max(worst[0], plain), max(worst[1], shifted),
                     max(worst[2], cond)]
        out[ua.name] = tuple(worst)
    return out


def _port(cfg, dense, toks, threads):
    from threadpoolctl import threadpool_limits

    from repro_torch.core import pipeline as TP

    before = torch.get_num_threads()
    torch.set_num_threads(threads)
    try:
        with threadpool_limits(limits=threads):
            return TP.compress_model(dense, cfg,
                                     {"tokens": toks},
                                     TP.CompressConfig(**RECIPE),
                                     device="cpu")
    finally:
        torch.set_num_threads(before)


def sweep(arch, shape):
    """{"threads": gaps of 1 against all threads, "jax": gaps of the port
    (all threads) against the JAX package} for ``arch``'s smoke config on
    ``shape`` numpy tokens."""
    import jax
    import jax.numpy as jnp

    from repro.configs import get_smoke_config as j_smoke
    from repro.core import pipeline as JP
    from repro_torch import bridge
    from repro_torch import configs as TC
    from repro_torch.models import model as TM

    jcfg = j_smoke(arch).replace(dtype="float32")
    tcfg = TC.get_smoke_config(arch).replace(dtype="float32")
    dense = TM.init_params(tcfg, 0, device="cpu")
    toks = np.random.default_rng(0).integers(0, tcfg.vocab_size, shape)
    cores = torch.get_num_threads()
    one, _ = _port(tcfg, dense, toks, 1)
    many, rep = _port(tcfg, dense, toks, cores)
    jdense = jax.tree.map(jnp.asarray, bridge.to_numpy(dense))
    jc, _ = JP.compress_model(jdense, jcfg,
                              {"tokens": jnp.asarray(toks)},
                              JP.CompressConfig(**RECIPE))
    jt = bridge.to_torch(jax.tree.map(np.asarray, jc))
    return {"cores": cores,
            "threads": unit_gaps(tcfg, one, many, rep),
            "jax": unit_gaps(tcfg, many, jt, rep)}


def main():
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", default="gemma3-1b")
    ap.add_argument("--tokens", type=int, nargs=2, default=(8, 32))
    args = ap.parse_args()
    t0 = time.perf_counter()
    out = sweep(args.arch, tuple(args.tokens))
    print(f"{args.arch}, {args.tokens[0]} x {args.tokens[1]} tokens, refine "
          f"off ({time.perf_counter() - t0:.1f} s, {out['cores']} threads)")
    print("unit | 1 vs all threads: plain, shifted | port vs JAX: plain, "
          "shifted | cond X'X'")
    for unit, (p1, s1, cond) in out["threads"].items():
        p2, s2, _ = out["jax"][unit]
        print(f"{unit} | {p1:.2e}, {s1:.2e} | {p2:.2e}, {s2:.2e} | "
              f"{cond:.2e}")
    print(json.dumps(out))


if __name__ == "__main__":
    main()
