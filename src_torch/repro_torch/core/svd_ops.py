"""Exact SVD primitives used by the master node.

Port of ``repro.core.svd_ops``.  Three operations appear in the paper:

  * leading singular vectors (u, v) = SV(G)      — DFW / DGSP / DNSP master step
  * singular-value shrinkage prox_{eta*lam ||.||_*}  — ProxGD / AccProxGD / ADMM
  * rank-r truncation                             — one-shot SVD truncation

``leading_sv`` lives in :mod:`repro_torch.core.spectral` and is
re-exported here.  The full-SVD paths below are the EXACT masters: the
oracles the lazy engine is tested against and the answers
``sv_engine="exact"`` selects.
"""
from __future__ import annotations

import torch

from .spectral import _simplex_cap, leading_sv  # noqa: F401  (re-export)


def sv_shrink(M: torch.Tensor, tau: float) -> torch.Tensor:
    """prox_{tau ||.||_*}(M) = U (S - tau)_+ V^T  (Cai-Candes-Shen SVT)."""
    U, S, Vt = torch.linalg.svd(M, full_matrices=False)
    S = torch.clamp(S - tau, min=0.0)
    return (U * S[None, :]) @ Vt


def nuclear_norm(M: torch.Tensor) -> torch.Tensor:
    return torch.sum(torch.linalg.svdvals(M))


def svd_truncate(M: torch.Tensor, r: int) -> torch.Tensor:
    """Best rank-r approximation (the one-shot estimator of §5)."""
    U, S, Vt = torch.linalg.svd(M, full_matrices=False)
    return (U[:, :r] * S[None, :r]) @ Vt[:r, :]


def project_nuclear_ball(M: torch.Tensor, radius: float) -> torch.Tensor:
    """Euclidean projection onto {||M||_* <= radius} (simplex proj on spectrum)."""
    U, S, Vt = torch.linalg.svd(M, full_matrices=False)
    if bool(torch.sum(S) > radius):
        S = _simplex_cap(S, radius)[0]
    return (U * S[None, :]) @ Vt


def gram_schmidt_append(U: torch.Tensor, u: torch.Tensor,
                        mask: torch.Tensor) -> torch.Tensor:
    """Orthogonalize u against the masked active columns of U and normalize.

    U: (p, K) with column-validity mask (K,). Used by DNSP (Alg. 6 lines 7-9).
    """
    coeffs = (U.T @ u) * mask
    u = u - U @ coeffs
    # second pass for numerical stability (classic twice-is-enough GS)
    coeffs = (U.T @ u) * mask
    u = u - U @ coeffs
    return u / torch.clamp(torch.linalg.norm(u), min=1e-30)
