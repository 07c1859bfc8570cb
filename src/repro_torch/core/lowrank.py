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

import numpy as np
import torch


def _svd_truncate(mat: torch.Tensor, k: int):
    """Rank-k SVD factors of ``mat`` (m, n) plus the FULL spectrum (the
    same decomposition serves the solve and the adaptive loss estimate):
    (A (m, k), B (n, k), σ) with mat ≈ A @ Bᵀ."""
    u, s, vh = torch.linalg.svd(mat.float(), full_matrices=False)
    return u[:, :k] * s[:k][None, :], vh[:k].T, s


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


def _whitened_map(w, cov_ab, cov_bb, eps: float, method: str):
    """(M = Wᵀ C L⁻ᵀ (m, n), L⁻ᵀ): the matrix the anchored solve
    truncates."""
    _, l_inv_t = _whitening_factors(cov_bb.float(), eps=eps, method=method)
    return w.float().T @ (cov_ab.float() @ l_inv_t), l_inv_t


def _anchored_core(w, cov_ab, cov_bb, k: int, eps: float, method: str):
    """The anchored solve's factor pair AND the full singular spectrum of M
    (the SVD computes it either way; the adaptive estimate sweep reads its
    tail instead of whitening and decomposing a second time)."""
    n, m = w.shape
    k = min(k, n, m)
    mat, l_inv_t = _whitened_map(w, cov_ab, cov_bb, eps, method)
    a_fac, b_fac, s = _svd_truncate(mat, k)                  # M ≈ A Bᵀ
    return {"v": l_inv_t @ b_fac, "u": a_fac.T.contiguous()}, s


def solve_anchored(w: torch.Tensor, cov_ab: torch.Tensor,
                   cov_bb: torch.Tensor, k: int, *, eps: float = 1e-6,
                   method: str = "eigh") -> Dict[str, torch.Tensor]:
    """min_{rank k} ||W A − W' B||² from covariances (Thm 3.2).

    w: (n, m) storage Wᵀ; cov_ab: (n, n) Σ x_rowᵀ x'_row; cov_bb: (n, n)
    Σ x'_rowᵀ x'_row.  Returns {"v": (n, k), "u": (k, m)}."""
    return _anchored_core(w, cov_ab, cov_bb, k, eps, method)[0]


def solve_anchored_with_spectrum(w, cov_ab, cov_bb, k: int, *,
                                 eps: float = 1e-6, method: str = "eigh"):
    """The anchored solve plus the full spectrum of M: one whitening, one
    SVD (the adaptive estimate sweep's path)."""
    return _anchored_core(w, cov_ab, cov_bb, k, eps, method)


def _agnostic_core(w, k: int):
    n, m = w.shape
    k = min(k, n, m)
    a_fac, b_fac, s = _svd_truncate(w.float().T, k)          # W ≈ A Bᵀ
    return {"v": b_fac, "u": a_fac.T.contiguous()}, s


def solve_agnostic(w: torch.Tensor, k: int) -> Dict[str, torch.Tensor]:
    """Input-agnostic truncated SVD: min ||W − W'||_F (Eckart–Young)."""
    return _agnostic_core(w, k)[0]


def solve_agnostic_with_spectrum(w: torch.Tensor, k: int):
    """The agnostic solve plus the full weight spectrum."""
    return _agnostic_core(w, k)


def whitened_spectrum(w: torch.Tensor, cov_ab: torch.Tensor,
                      cov_bb: torch.Tensor, *, eps: float = 1e-6,
                      method: str = "eigh") -> torch.Tensor:
    """Singular values of M = Wᵀ C L⁻ᵀ, the spectrum the anchored solve
    truncates: the exact objective loss of keeping rank k is the tail
    energy Σ_{j>k} σ_j² (Thm 3.2)."""
    mat, _ = _whitened_map(w, cov_ab, cov_bb, eps, method)
    return torch.linalg.svdvals(mat)


def weight_spectrum(w: torch.Tensor) -> torch.Tensor:
    """Plain singular values of W: the agnostic objective's analogue of
    ``whitened_spectrum`` (Eckart–Young tail energy)."""
    return torch.linalg.svdvals(w.float())


def spectrum_tail_energy(spectrum, k: int) -> float:
    """Truncation-loss estimate Σ_{j>k} σ_j² (summed over leading bank
    axes for stacked expert spectra).  The reference's own numpy
    expression on a float32 copy, so the estimate is a function of the
    spectrum's bits alone."""
    if torch.is_tensor(spectrum):
        spectrum = spectrum.detach().float().cpu().numpy()
    s = np.asarray(spectrum, dtype=np.float32)
    return float(np.sum(s[..., k:] ** 2))


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
