"""One-shot rank-r truncation by cold subspace iteration.

Port of the ``truncate_factors`` / ``truncate`` half of
``repro.core.spectral`` with the helpers they use.  The reference runs
the sweep loop under ``lax.while_loop`` and picks the lazy or exact
answer with ``lax.cond`` inside one traced program; here both are
Python control flow, and each early-exit test reads one scalar back to
the host.  That sync is off the scoring path: factorizing is done once
per published model.

Everything on the lazy path is gemm/QR work on (p, K) panels with
K = r + oversample, started from a deterministic cosine probe (no
PRNG), and accepted only when the kept triplets' residuals and the
deflated tail pass their tests; otherwise the exact SVD answers.
``leading_sv`` and ``ShrinkEngine`` come with the solver slice.
"""
from __future__ import annotations

from typing import Tuple

import torch

_TINY = 1e-30

Factors = Tuple[torch.Tensor, torch.Tensor, torch.Tensor]


def _probe(n: int, K: int, dtype: torch.dtype, device: torch.device
           ) -> torch.Tensor:
    """Deterministic dense (n, K) probe with orthonormal columns: a
    cosine lattice at incommensurate frequencies, orthonormalized once
    (the reference's formula, so both start from the same subspace)."""
    i = torch.arange(n, dtype=dtype, device=device)[:, None]
    j = torch.arange(K, dtype=dtype, device=device)[None, :]
    P = torch.cos(0.37 + i * (1.0 + 0.61803398875 * j)) + 0.1
    return torch.linalg.qr(P)[0]


def _colnorms(X: torch.Tensor) -> torch.Tensor:
    return torch.sqrt(torch.sum(X * X, dim=0))


def _sweeps(M: torch.Tensor, V0: torch.Tensor, s0: torch.Tensor,
            max_sweeps: int, drift_tol: float
            ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, int]:
    """Block subspace refinement ``V ← qr(Mᵀ qr(M V))`` until the Ritz
    spectrum stops moving (relative drift ≤ ``drift_tol``) or
    ``max_sweeps`` is hit.  Returns ``(U (p,K), V (m,K), R (K,K),
    sweeps_run)`` with ``Mᵀ U = V R``."""
    p, _ = M.shape
    K = V0.shape[1]
    U = M.new_zeros((p, K))
    R = M.new_zeros((K, K))
    V, s = V0, s0
    s_prev = torch.full((K,), float("inf"), dtype=M.dtype, device=M.device)
    i = 0
    while i < max_sweeps:
        if i >= 1:
            drift = torch.max(torch.abs(s - s_prev))
            scale = torch.clamp(s[0], min=_TINY)
            if not bool(drift > drift_tol * scale):
                break
        U, _ = torch.linalg.qr(M @ V)
        V, R = torch.linalg.qr(M.T @ U)
        s, s_prev = torch.linalg.svdvals(R), s
        i += 1
    return U, V, R, i


def _ritz_from_R(U: torch.Tensor, V: torch.Tensor, R: torch.Tensor) -> Factors:
    """Rayleigh–Ritz extraction from the last sweep's QR factor: the
    projected block is B = Uᵀ M V = Rᵀ, so the approximate singular
    triplets are (U Ub, s, V Vb) for the small SVD Rᵀ = Ub s Vbᵀ."""
    Ub, s, Vbt = torch.linalg.svd(R.T)
    return U @ Ub, s, V @ Vbt.T


def _tail_power(E: torch.Tensor, W0: torch.Tensor, iters: int
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Block-power estimate of ‖E‖₂, started from ``W0`` (m, b)."""
    Wb = W0
    for _ in range(iters):
        Wb = torch.linalg.qr(E.T @ (E @ Wb))[0]
    return torch.max(_colnorms(E @ Wb)), Wb


def _residuals(E: torch.Tensor, Ur: torch.Tensor, Vr: torch.Tensor
               ) -> torch.Tensor:
    """Two-sided per-triplet residuals from the explicit deflation:
    ``M v_i − s_i u_i = E v_i`` and ``Mᵀ u_i − s_i v_i = Eᵀ u_i``."""
    return torch.maximum(_colnorms(E @ Vr), _colnorms(E.T @ Ur))


def _factor_exact(M: torch.Tensor, r: int) -> Factors:
    U, S, Vt = torch.linalg.svd(M, full_matrices=False)
    return U[:, :r], S[:r], Vt[:r, :].T


def truncate_factors(M: torch.Tensor, r: int, oversample: int = 8,
                     max_sweeps: int = 24, drift_tol: float = 1e-6,
                     res_tol: float = 5e-6) -> Factors:
    """Rank-r factors ``(U (p,r), s (r,), V (m,r))`` of the best rank-r
    approximation ``M ≈ U diag(s) Vᵀ``, by cold subspace iteration.

    Accepts the lazy answer iff every KEPT triplet's residual is
    ≤ res_tol·s₁ and the block-power estimate of the deflated tail is
    no larger than the r-th Ritz value (a direction the probe never
    excited would show there); anything else takes the exact SVD.
    ``r`` is clamped to min(p, m), as in the reference.
    """
    p, m = M.shape
    r = min(r, p, m)
    K = min(r + oversample, min(p, m))
    if K >= min(p, m):
        return _factor_exact(M, r)
    V0 = _probe(m, K, M.dtype, M.device)
    U, V, R, _ = _sweeps(M, V0, M.new_zeros((K,)), max_sweeps, drift_tol)
    Ur, s, Vr = _ritz_from_R(U, V, R)
    E = M - (Ur * s[None, :]) @ Vr.T
    res = _residuals(E, Ur, Vr)
    scale = torch.clamp(s[0], min=_TINY)
    conv_ok = torch.max(res[:r]) <= res_tol * scale
    t_est, _ = _tail_power(E, _probe(m, 4, M.dtype, M.device), 6)
    tail_ok = t_est <= torch.maximum(s[r - 1], res_tol * scale)
    if bool(conv_ok & tail_ok):
        return Ur[:, :r], s[:r], Vr[:, :r]
    return _factor_exact(M, r)


def truncate(M: torch.Tensor, r: int, oversample: int = 8,
             max_sweeps: int = 24, drift_tol: float = 1e-6,
             res_tol: float = 5e-6) -> torch.Tensor:
    """Best rank-r approximation: the composed form of
    :func:`truncate_factors`."""
    U, s, V = truncate_factors(M, r, oversample, max_sweeps, drift_tol,
                               res_tol)
    return (U * s[None, :]) @ V.T
