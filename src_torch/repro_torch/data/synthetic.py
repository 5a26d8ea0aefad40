"""Simulation data generators matching §5 of the paper.

Port of ``repro.data.synthetic``, drawing through
:mod:`repro_torch.core.prng`, so a key gives the reference's dataset:

  * W* = U S V^T where U, V are singular vectors of A B^T
    (A: p x r, B: m x r, std normal) and diag(S) = [1, 1/1.5, 1/1.5^2, ...].
  * x_ji ~ N(0, Sigma), Sigma_ab = 2^{-c |a-b|}; c = 1 for the base setup
    (Figs 1-2) and c = 0.1 for the highly-correlated setup (Fig 3).
  * regression:      y | x ~ N(<w*_j, x>, 1)
  * classification:  y | x ~ Bernoulli(sigmoid(<w*_j, x>)), labels in {-1,+1}.

Every draw runs on the key's device; :func:`generate` moves the key to
``device`` first (default: the card).  The uniform draws, and so the
classification labels' coin flips, are the reference's bit for bit; the
normal draws agree to ~2.5e-7 relative (:func:`prng.normal`), and the
products built on them (W*, X, y) to float32 rounding of that.
"""
from __future__ import annotations

import dataclasses
from typing import Tuple

import torch

from .._device import DeviceLike, resolve_device
from ..core import prng
from ..core.spectral import truncate_factors


@dataclasses.dataclass(frozen=True)
class SimSpec:
    p: int = 100          # feature dimension
    m: int = 30           # number of tasks / machines
    r: int = 5            # true rank
    n: int = 50           # samples per task
    corr_decay: float = 1.0   # c in Sigma_ab = 2^{-c|a-b|}
    task: str = "regression"  # or "classification"
    noise: float = 1.0


def make_wstar(key: torch.Tensor, p: int, m: int, r: int,
               dtype=torch.float32) -> torch.Tensor:
    """W* (p, m) = U diag(1.5^-i) V^T from the top-r factors of A B^T."""
    ka, kb = prng.split(key)
    A = prng.normal(ka, (p, r), dtype)
    B = prng.normal(kb, (m, r), dtype)
    # W* is the sign-invariant composition U diag(s) V^T
    U, _, V = truncate_factors(A @ B.T, r)
    s = (1.0 / 1.5) ** torch.arange(r, dtype=dtype, device=key.device)
    return (U * s[None, :]) @ V.T


def feature_cov(p: int, corr_decay: float, dtype=torch.float32,
                device: DeviceLike = None) -> torch.Tensor:
    """Sigma (p, p) with Sigma_ab = 2^{-c |a-b|}, in float32 as the
    reference computes it."""
    idx = torch.arange(p, device=resolve_device(device))
    gap = torch.abs(idx[:, None] - idx[None, :]).to(dtype)
    return torch.pow(2.0, -corr_decay * gap).to(dtype)


def _sample_features(key: torch.Tensor, m: int, n: int,
                     Sigma_chol: torch.Tensor, chunks: int = 1
                     ) -> torch.Tensor:
    """N(0, Sigma) features (m, n, p).  ``chunks > 1`` draws the sample
    axis in ``n / chunks`` blocks with per-block keys (the reference's
    bounded-memory large-n draw; its dataset differs from the one-key
    draw, so a spec's data is reproducible per (key, chunks) pair)."""
    p = Sigma_chol.shape[0]
    if chunks == 1:
        return prng.normal(key, (m, n, p), Sigma_chol.dtype) @ Sigma_chol.T
    if n % chunks:
        raise ValueError(f"n={n} not divisible by sample_chunks={chunks}")
    parts = [prng.normal(k, (m, n // chunks, p), Sigma_chol.dtype)
             @ Sigma_chol.T
             for k in prng.split(key, chunks)]
    return torch.cat(parts, dim=1)


def generate(key: torch.Tensor, spec: SimSpec, sample_chunks: int = 1,
             device: DeviceLike = None
             ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor,
                        torch.Tensor]:
    """Returns (Xs (m,n,p), ys (m,n), W* (p,m), Sigma (p,p)) float32 on
    ``device`` (default: the card).

    ``sample_chunks > 1`` generates the feature tensor in blocks along
    the sample axis (see :func:`_sample_features`)."""
    dev = resolve_device(device)
    key = key.to(dev)
    kw, kx, ky = prng.split(key, 3)
    Wstar = make_wstar(kw, spec.p, spec.m, spec.r)
    Sigma = feature_cov(spec.p, spec.corr_decay, device=dev)
    eye = torch.eye(spec.p, dtype=Sigma.dtype, device=dev)
    chol = torch.linalg.cholesky(Sigma + 1e-9 * eye)
    Xs = _sample_features(kx, spec.m, spec.n, chol, chunks=sample_chunks)
    margins = torch.einsum("mnp,pm->mn", Xs, Wstar)
    if spec.task == "regression":
        ys = margins + spec.noise * prng.normal(ky, tuple(margins.shape))
    elif spec.task == "classification":
        prob1 = torch.sigmoid(margins)
        ys = torch.where(prng.uniform(ky, tuple(margins.shape)) < prob1,
                         1.0, -1.0)
    else:
        raise ValueError(spec.task)
    return Xs, ys, Wstar, Sigma


# ---------------------------------------------------------------------------
# Closed-form / monte-carlo excess risk, for the plots
# ---------------------------------------------------------------------------
def excess_risk_regression(W: torch.Tensor, Wstar: torch.Tensor,
                           Sigma: torch.Tensor) -> torch.Tensor:
    """E L(W) - E L(W*) = (1/2m) sum_j (w_j - w*_j)' Sigma (w_j - w*_j)."""
    D = W - Wstar
    return 0.5 * torch.mean(torch.einsum("pm,pq,qm->m", D, Sigma, D))


def excess_risk_classification(key: torch.Tensor, W: torch.Tensor,
                               Wstar: torch.Tensor, Sigma: torch.Tensor,
                               n_test: int = 20000) -> torch.Tensor:
    """Monte-carlo logistic excess risk under the generative model, on
    the tensors' device."""
    p, m = W.shape
    key = key.to(W.device)
    eye = torch.eye(p, dtype=Sigma.dtype, device=Sigma.device)
    chol = torch.linalg.cholesky(Sigma + 1e-9 * eye)
    kx, ky = prng.split(key)
    X = prng.normal(kx, (n_test, p)) @ chol.T
    marg_star = X @ Wstar                      # (n_test, m)
    prob1 = torch.sigmoid(marg_star)
    y = torch.where(prng.uniform(ky, tuple(prob1.shape)) < prob1, 1.0, -1.0)

    def risk(Wm):
        return torch.mean(torch.nn.functional.softplus(-y * (X @ Wm)))

    return risk(W) - risk(Wstar)
