"""Theorem 3.2: closed-form anchored-adaptive low-rank solve, on torch.linalg.

Counterpart of ``src/repro/core/lowrank.py``.  Weights are stored as
w = Wᵀ (in, out) and applied as y = x @ w; the solve returns
{"v": (n, k), "u": (k, m)} with y ≈ (x @ v) @ u, in fp32.  With
C = cov_ab and S = cov_bb = L Lᵀ the optimum is

    W'* = SVD_k(W C S⁻¹ L) L⁻¹,   M = Wᵀ C L⁻ᵀ (m, n),  v = L⁻ᵀ B_k, u = A_kᵀ.

The eigenvector signs and the rotations inside degenerate singular
subspaces are backend-specific, so results are compared as composed maps
v @ u, never factor by factor.
"""

from __future__ import annotations

from typing import Dict

import torch


def _svd_truncate(mat: torch.Tensor, k: int):
    """Rank-k SVD factors of ``mat`` (m, n): (A (m, k), B (n, k)) with
    mat ≈ A @ Bᵀ."""
    u, s, vh = torch.linalg.svd(mat.float(), full_matrices=False)
    return u[:, :k] * s[:k][None, :], vh[:k].T


def _whitening_factors(s_cov: torch.Tensor, *, eps: float, method: str):
    """Return (L, L⁻ᵀ) for S = L Lᵀ with regularization.

    eigh: L = Q Λ^{1/2}, L⁻ᵀ = Q Λ^{-1/2}, eigenvalues floored at
    eps·max λ.  cholesky: lower-triangular L of S + ridge·I."""
    n = s_cov.shape[0]
    s_cov = 0.5 * (s_cov + s_cov.T)
    eye = torch.eye(n, dtype=s_cov.dtype, device=s_cov.device)
    if method == "cholesky":
        ridge = eps * torch.clamp(torch.trace(s_cov) / n, min=1e-12)
        l_fac = torch.linalg.cholesky(s_cov + ridge * eye)
        l_inv_t = torch.linalg.solve_triangular(l_fac, eye, upper=False).T
        return l_fac, l_inv_t
    lam, q = torch.linalg.eigh(s_cov)
    floor = eps * torch.clamp(lam.max(), min=1e-12)
    lam = torch.maximum(lam, floor)                   # Tikhonov clamp
    sqrt_lam = torch.sqrt(lam)
    return q * sqrt_lam[None, :], q / sqrt_lam[None, :]


def solve_anchored(w: torch.Tensor, cov_ab: torch.Tensor,
                   cov_bb: torch.Tensor, k: int, *, eps: float = 1e-6,
                   method: str = "eigh") -> Dict[str, torch.Tensor]:
    """min_{rank k} ||W A − W' B||² from covariances (Thm 3.2).

    w: (n, m) storage Wᵀ; cov_ab: (n, n) Σ x_rowᵀ x'_row; cov_bb: (n, n)
    Σ x'_rowᵀ x'_row.  Returns {"v": (n, k), "u": (k, m)}."""
    n, m = w.shape
    k = min(k, n, m)
    _, l_inv_t = _whitening_factors(cov_bb.float(), eps=eps, method=method)
    mat = w.float().T @ (cov_ab.float() @ l_inv_t)           # (m, n)
    a_fac, b_fac = _svd_truncate(mat, k)                     # M ≈ A Bᵀ
    return {"v": l_inv_t @ b_fac, "u": a_fac.T.contiguous()}


def solve_agnostic(w: torch.Tensor, k: int) -> Dict[str, torch.Tensor]:
    """Input-agnostic truncated SVD: min ||W − W'||_F (Eckart–Young)."""
    n, m = w.shape
    k = min(k, n, m)
    a_fac, b_fac = _svd_truncate(w.float().T, k)             # W ≈ A Bᵀ
    return {"v": b_fac, "u": a_fac.T.contiguous()}


def factor_error(w, factors, cov_ab, cov_bb, cov_aa) -> torch.Tensor:
    """||W A − W' B||² from covariances only:
    tr(W S_aa Wᵀ) − 2 tr(W C W'ᵀ) + tr(W' S_bb W'ᵀ)."""
    wf = w.float().T                                          # (m, n)
    wp = (factors["v"] @ factors["u"]).float().T              # (m, n)
    t1 = torch.sum((wf @ cov_aa) * wf)
    t2 = torch.sum((wf @ cov_ab) * wp)
    t3 = torch.sum((wp @ cov_bb) * wp)
    return t1 - 2.0 * t2 + t3


def merge_factors(factors) -> torch.Tensor:
    """Dense (n, m) reconstruction of the factorized weight."""
    return factors["v"] @ factors["u"]
