"""Spectral master: one-shot truncation, the leading singular triplet
and the warm-started shrinkage engine.

Port of ``repro.core.spectral``.  The reference runs its loops under
``lax.while_loop`` and picks the lazy or exact answer with ``lax.cond``
/ ``lax.switch`` inside one traced program; here both are Python control
flow, and each early-exit test reads one scalar back to the host.  The
exit tests are the reference's, in the same place, so both packages take
the same number of iterations and the same branch on the same data.

Everything on the lazy path is gemm/QR work on (p, K) panels with
K = r + oversample, started from a deterministic cosine probe (no
PRNG), and accepted only when the kept triplets' residuals and the
deflated tail pass their tests; otherwise the exact SVD answers.

* :func:`truncate_factors` / :func:`truncate` — the cold one-shot rank-r
  truncation (the serving artifact, the svd_trunc master).
* :func:`leading_sv` — the K = 1 case: power iteration with a residual
  exit (the DFW / DGSP / DNSP master step).
* :class:`ShrinkEngine` — the prox-family master: singular-value
  shrinkage and nuclear-ball projection on a basis carried across
  rounds.  Its carry holds tensors on the device plus two host ints
  (``warm``, ``exact_rounds``): the branch is decided on the host
  anyway, so the counters need no device round trip.
"""
from __future__ import annotations

import math
from typing import Dict, Tuple

import torch

_TINY = 1e-30

Factors = Tuple[torch.Tensor, torch.Tensor, torch.Tensor]
Carry = Dict[str, object]


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


def _simplex_cap(S: torch.Tensor, radius) -> Tuple[torch.Tensor, torch.Tensor]:
    """Project a DESCENDING spectrum onto the l1 ball (Duchi et al.).

    Returns (projected spectrum, water level θ).  Shared by the exact
    ``svd_ops.project_nuclear_ball`` and the lazy engine.
    """
    k = S.shape[0]
    css = torch.cumsum(S, dim=0)
    idx = torch.arange(1, k + 1, device=S.device)
    cond = S - (css - radius) / idx.to(S.dtype) > 0
    rho = torch.max(torch.where(cond, idx, torch.zeros_like(idx)))
    theta = (css[rho - 1] - radius) / rho.to(S.dtype)
    return torch.clamp(S - theta, min=0.0), theta


# ---------------------------------------------------------------------------
# the k = 1 case: leading singular triplet with residual early exit
# ---------------------------------------------------------------------------
def leading_sv(G: torch.Tensor, iters: int = 60, tol: float = 1e-6,
               seed: int = 0) -> Factors:
    """Top singular triplet (u, s, v) of G (p, m) — the K = 1 engine case.

    Power iteration on GᵀG from a deterministic, data-derived start.
    After every step it tests the eigen-residual ‖GᵀG v − λ v‖ ≤ tol·λ
    of the vector it stepped from and stops once that holds, capped at
    ``iters`` steps (the reference's ``while_loop``: the step that
    passes the test still normalizes).  ``seed`` is unused, as in the
    reference.
    """
    p, m = G.shape
    probe = (1.0 + 0.1 * torch.cos(torch.arange(m, dtype=G.dtype,
                                                device=G.device))) \
        / math.sqrt(m)
    v = G.T @ (G @ probe) + 1e-12 * probe
    v = v / torch.clamp(torch.linalg.norm(v), min=_TINY)
    for _ in range(iters):
        w = G.T @ (G @ v)
        lam = w @ v                       # Rayleigh quotient of GᵀG
        done = torch.linalg.norm(w - lam * v) <= tol * torch.clamp(lam, min=_TINY)
        v = w / torch.clamp(torch.linalg.norm(w), min=_TINY)
        if bool(done):
            break
    u = G @ v
    s = torch.linalg.norm(u)
    u = u / torch.clamp(s, min=_TINY)
    # sign convention: the entries of u sum to >= 0 (determinism)
    sign = torch.where(torch.sum(u) >= 0, 1.0, -1.0).to(G.dtype)
    return u * sign, s, v * sign


# ---------------------------------------------------------------------------
# the shrinkage engine (ProxGD / AccProxGD / ADMM / Centralize masters)
# ---------------------------------------------------------------------------
class ShrinkEngine:
    """Per-solver spectral master for the prox-family shrinkage step.

    ``shrink(M, tau, carry)`` is a drop-in for ``svd_ops.sv_shrink``
    that also returns the nuclear norm of its output and threads the
    warm-start carry.  ``mode="exact"`` — or a block K = rank +
    oversample that already covers min(p, m) — is the plain full-SVD
    master with an empty carry.  Neither engine communicates (the
    master is replicated), so the CommLog is identical either way.
    """

    def __init__(self, p: int, m: int, dtype=torch.float32,
                 device=None, mode: str = "lazy",
                 rank: int = 5, oversample: int = 8, max_sweeps: int = 5,
                 drift_tol: float = 1e-5, res_tol: float = 5e-5,
                 tail_iters: int = 3, tail_block: int = 4,
                 tail_margin: float = 0.97, fro_margin: float = 0.95):
        if mode not in ("lazy", "exact"):
            raise ValueError(
                f"unknown sv_engine {mode!r}; have 'lazy', 'exact'")
        self.p, self.m = int(p), int(m)
        self.dtype = dtype
        self.device = torch.device("cpu") if device is None \
            else torch.device(device)
        self.K = min(int(rank) + int(oversample), min(self.p, self.m))
        # a block as wide as the spectrum is a full SVD with extra steps
        self.lazy = (mode == "lazy") and self.K < min(self.p, self.m)
        self.mode = "lazy" if self.lazy else "exact"
        self.max_sweeps = int(max_sweeps)
        self.drift_tol = float(drift_tol)
        self.res_tol = float(res_tol)
        self.tail_iters = int(tail_iters)
        self.tail_block = min(int(tail_block), self.m)
        self.tail_margin = float(tail_margin)
        # the rigorous (Frobenius/Weyl) arm of the tail test, kept at or
        # below tail_margin
        self.fro_margin = float(min(fro_margin, tail_margin))

    # -- carry ---------------------------------------------------------
    def init_carry(self) -> Carry:
        """The carried right basis ``V``, its Ritz spectrum ``s``, the
        tail-probe block ``T`` (tensors on the engine's device), the
        warm flag (cold ⇒ exact fallback on round one) and the fallback
        counter (host ints)."""
        if not self.lazy:
            return {}
        # the carried basis V is kept contiguous whichever branch made
        # it (QR, the SVD's Vh view, or a Ritz product each lay it out
        # otherwise), so every round reads it in one layout
        return {"V": _probe(self.m, self.K, self.dtype,
                            self.device).contiguous(),
                "s": torch.zeros((self.K,), dtype=self.dtype,
                                 device=self.device),
                "T": _probe(self.m, self.tail_block, self.dtype, self.device),
                "warm": 0, "exact_rounds": 0}

    def stats(self, carry: Carry) -> Dict[str, int]:
        """Host-side diagnostics from a final carry (extras-friendly)."""
        if not self.lazy:
            return {}
        return {"sv_exact_rounds": int(carry["exact_rounds"])}

    def device_stats(self, carry: Carry) -> Dict[str, torch.Tensor]:
        """Cumulative exact-SVD fallback rounds as an i32 scalar."""
        n = int(carry["exact_rounds"]) if self.lazy else 0
        return {"sv_exact": torch.tensor(n, dtype=torch.int32,
                                         device=self.device)}

    def _lazy_pass(self, M: torch.Tensor, carry: Carry):
        """Refine the carried basis, Ritz-extract and deflate: the pieces
        both master steps test."""
        U, V, R, _ = _sweeps(M, carry["V"], carry["s"],
                             self.max_sweeps, self.drift_tol)
        Ur, s, Vr = _ritz_from_R(U, V, R)
        scale = torch.clamp(s[0], min=_TINY)
        # explicit deflation: everything the block failed to capture
        E = M - (Ur * s[None, :]) @ Vr.T
        res = _residuals(E, Ur, Vr)
        fro = torch.linalg.norm(E)
        t_est, Tb = _tail_power(E, carry["T"], self.tail_iters)
        return Ur, s, Vr, scale, res, fro, t_est, Tb

    # -- the master step ----------------------------------------------
    def _exact_shrink(self, M, tau):
        U, S, Vt = torch.linalg.svd(M, full_matrices=False)
        s = torch.clamp(S - tau, min=0.0)
        return (U * s[None, :]) @ Vt, torch.sum(s), S, Vt

    def shrink(self, M: torch.Tensor, tau, carry: Carry
               ) -> Tuple[torch.Tensor, torch.Tensor, Carry]:
        """prox_{tau‖·‖_*}(M) → (W, ‖W‖_*, carry').

        Lazy path: refine the carried basis, Ritz-extract, shrink the
        top-K spectrum, and accept iff the warm carry's shrink-weighted
        residuals are ≤ res_tol·s₁ and the deflated remainder sits below
        τ (‖E‖_F ≤ fro_margin·τ, or the block-power estimate ≤
        tail_margin·τ).  Anything else — including the cold first call —
        takes the exact SVD, which also reseeds the carry.  The tail
        block is refreshed on either branch, as in the reference.
        """
        if not self.lazy:
            W, nn, _, _ = self._exact_shrink(M, tau)
            return W, nn, carry

        K = self.K
        Ur, s, Vr, scale, res, fro, t_est, Tb = self._lazy_pass(M, carry)
        shr = torch.clamp(s - tau, min=0.0)
        # shrink-weighted convergence (weight (s_i − τ)₊ / s_i): triplets
        # hugging the threshold are output-insensitive
        conv_ok = torch.max(res * shr / torch.clamp(s, min=_TINY)) <= \
            self.res_tol * scale
        tail_ok = (fro <= self.fro_margin * tau) | \
            (t_est <= self.tail_margin * tau)
        if carry["warm"] > 0 and bool(conv_ok & tail_ok):
            W, nn, Vc, sc, ex = (Ur * shr[None, :]) @ Vr.T, torch.sum(shr), \
                Vr, s, 0
        else:
            # one factorization serves both the shrink and the carry
            # reseed (true top-K right subspace)
            W, nn, S, Vt = self._exact_shrink(M, tau)
            Vc, sc, ex = Vt[:K].T, S[:K], 1
        return W, nn, {"V": Vc.contiguous(), "s": sc, "T": Tb, "warm": 1,
                       "exact_rounds": carry["exact_rounds"] + ex}

    def project(self, M: torch.Tensor, radius, carry: Carry
                ) -> Tuple[torch.Tensor, Carry]:
        """Euclidean projection onto {‖·‖_* ≤ radius} → (W, carry').

        Lazy path: certify the matrix inside the ball
        (``Σs + √min(p,m)·‖E‖_F ≤ radius``) and return it unchanged, or
        certify the projection rank-limited (``Σs > radius``, converged
        triplets, tail below the water level θ), or fall back to exact.
        """
        if not self.lazy:
            from . import svd_ops
            return svd_ops.project_nuclear_ball(M, radius), carry

        K = self.K
        Ur, s, Vr, scale, res, fro, t_est, Tb = self._lazy_pass(M, carry)
        s_proj, theta = _simplex_cap(s, radius)
        q = min(self.p, self.m)
        nuc_ub = torch.sum(s) + math.sqrt(q) * fro
        conv_ok = torch.max(res * s_proj / torch.clamp(s, min=_TINY)) <= \
            self.res_tol * scale
        warm = carry["warm"] > 0
        tail_below = (fro <= self.fro_margin * theta) | \
            (t_est <= self.tail_margin * theta)
        if warm and bool(nuc_ub <= radius):
            W, Vc, sc, ex = M, Vr, s, 0
        elif warm and bool((torch.sum(s) > radius) & conv_ok & tail_below):
            W, Vc, sc, ex = (Ur * s_proj[None, :]) @ Vr.T, Vr, s, 0
        else:
            # one factorization serves both the projection and the reseed
            Ue, Se, Vte = torch.linalg.svd(M, full_matrices=False)
            S_proj = _simplex_cap(Se, radius)[0] if bool(torch.sum(Se) > radius) \
                else Se
            W, Vc, sc, ex = (Ue * S_proj[None, :]) @ Vte, Vte[:K].T, Se[:K], 1
        return W, {"V": Vc.contiguous(), "s": sc, "T": Tb, "warm": 1,
                   "exact_rounds": carry["exact_rounds"] + ex}


def shrink_engine(prob, engine: str = "lazy", rank=None,
                  oversample: int = 8, **kw) -> ShrinkEngine:
    """Build the shrinkage master for one solve of ``prob``, on the
    problem's device.  ``rank`` defaults to the problem's assumed rank
    bound; the carried block is rank + oversample wide."""
    r = int(prob.r if rank is None else rank)
    return ShrinkEngine(prob.p, prob.m, prob.Xs.dtype, prob.Xs.device,
                        mode=engine, rank=r, oversample=oversample, **kw)


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
