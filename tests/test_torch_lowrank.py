"""Closed-form solves and rank math: the port against the JAX package.

Factor pairs are compared as composed maps v @ u — eigenvector signs and
SVD gauges differ between backends, the maps do not.
"""

from __future__ import annotations

import torch_thread_cap  # noqa: F401  (thread caps under pytest-xdist)
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import lowrank as JL
from repro.core import ranks as JR
from repro_torch.core import lowrank as TL
from repro_torch.core import ranks as TR


def _problem(seed, n=48, m=40, t=256, degenerate=False):
    rng = np.random.default_rng(seed)
    w = rng.standard_normal((n, m)).astype(np.float32)
    x = rng.standard_normal((t, n)).astype(np.float32)
    if degenerate:
        # a near-degenerate activation spectrum: a tight cluster of equal
        # scales plus a few dominant directions
        scales = np.ones(n, np.float32)
        scales[:4] = 10.0
        scales[4:] += 1e-4 * np.arange(n - 4)
        x = x * scales
    xp = x + 0.1 * rng.standard_normal((t, n)).astype(np.float32)
    return w, x.T @ xp, xp.T @ xp


def _rel(a, b):
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


@pytest.mark.parametrize("method", ["eigh", "cholesky"])
@pytest.mark.parametrize("degenerate", [False, True])
def test_solve_anchored_composed_map(method, degenerate):
    # fp32 eigh/cholesky + SVD on two LAPACK builds: composed maps to 1e-4
    # relative Frobenius
    w, cab, cbb = _problem(0, degenerate=degenerate)
    k = 12
    jf = JL.solve_anchored(jnp.asarray(w), jnp.asarray(cab), jnp.asarray(cbb),
                           k, method=method)
    tf = TL.solve_anchored(torch.from_numpy(w), torch.from_numpy(cab),
                           torch.from_numpy(cbb), k, method=method)
    assert tuple(tf["v"].shape) == (48, k) and tuple(tf["u"].shape) == (k, 40)
    assert _rel(TL.merge_factors(tf).numpy(),
                np.asarray(JL.merge_factors(jf))) < 1e-4


def test_solve_agnostic_composed_map():
    w, _, _ = _problem(1)
    jf = JL.solve_agnostic(jnp.asarray(w), 9)
    tf = TL.solve_agnostic(torch.from_numpy(w), 9)
    assert _rel(TL.merge_factors(tf).numpy(),
                np.asarray(JL.merge_factors(jf))) < 1e-4


def test_factor_error_matches_reference():
    w, cab, cbb = _problem(2)
    caa = cab.T @ cab / 256
    tf = TL.solve_anchored(torch.from_numpy(w), torch.from_numpy(cab),
                           torch.from_numpy(cbb), 10)
    want = JL.factor_error(jnp.asarray(w),
                           {k: jnp.asarray(v.numpy()) for k, v in tf.items()},
                           jnp.asarray(cab), jnp.asarray(cbb),
                           jnp.asarray(caa))
    got = TL.factor_error(torch.from_numpy(w), tf, torch.from_numpy(cab),
                          torch.from_numpy(cbb), torch.from_numpy(caa))
    np.testing.assert_allclose(float(got), float(want), rtol=1e-4)


@pytest.mark.parametrize("remap", [False, True])
def test_rank_for_ratio_integer_equal(remap):
    for m in (1, 7, 64, 160, 4096, 11008):
        for n in (1, 9, 64, 4096, 32000):
            for ratio in (0.05, 0.2, 0.4, 0.6, 0.8, 0.999, 1.0, 1.3):
                for multiple in (1, 8, 128):
                    assert TR.rank_for_ratio(
                        m, n, ratio, remap=remap, multiple=multiple) == \
                        JR.rank_for_ratio(m, n, ratio, remap=remap,
                                          multiple=multiple)


@pytest.mark.parametrize("remap", [False, True])
def test_achieved_ratio_equal(remap):
    for m in (1, 7, 64, 160, 4096, 11008):
        for n in (1, 9, 64, 4096, 32000):
            for k in (1, 8, 19, 1232, 1792):
                assert TR.achieved_ratio(m, n, k, remap=remap) == \
                    JR.achieved_ratio(m, n, k, remap=remap)
