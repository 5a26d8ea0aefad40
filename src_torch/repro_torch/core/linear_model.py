"""Per-task linear-model primitives (port of ``repro.core.linear_model``).

Everything here is written for a SINGLE task (X: (n, p), y: (n,)) and
is lifted over the task axis with ``torch.func.vmap`` by the batched
helpers at the bottom and by :mod:`repro_torch.core.worker_ops`.  The
per-task gradient keeps the 1/m factor of the global objective OUT, as
the reference does, so the same helpers serve the global objective and
the purely local ERM solves.  The reference's ``fori_loop``s are plain
loops with fixed trip counts.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from .losses import Loss


def _eye(p: int, like: torch.Tensor) -> torch.Tensor:
    return torch.eye(p, dtype=like.dtype, device=like.device)


def predict(w: torch.Tensor, X: torch.Tensor) -> torch.Tensor:
    return X @ w


def task_loss(loss: Loss, w: torch.Tensor, X: torch.Tensor, y: torch.Tensor,
              l2: float = 0.0) -> torch.Tensor:
    """L_nj(w) (+ optional ridge term used for real-data experiments)."""
    val = torch.mean(loss.value(X @ w, y))
    if l2:
        val = val + 0.5 * l2 * torch.sum(w * w)
    return val


def task_grad(loss: Loss, w: torch.Tensor, X: torch.Tensor, y: torch.Tensor,
              l2: float = 0.0) -> torch.Tensor:
    """grad_w L_nj(w) = (1/n) X^T l'(Xw, y) (+ l2 w)."""
    n = X.shape[0]
    g = X.T @ loss.d1(X @ w, y) / n
    if l2:
        g = g + l2 * w
    return g


def task_hessian(loss: Loss, w: torch.Tensor, X: torch.Tensor, y: torch.Tensor,
                 l2: float = 0.0) -> torch.Tensor:
    """hess_w L_nj(w) = (1/n) X^T diag(l''(Xw,y)) X (+ l2 I)."""
    n, p = X.shape
    d2 = loss.d2(X @ w, y)
    Hm = (X * d2[:, None]).T @ X / n
    if l2:
        Hm = Hm + l2 * _eye(p, X)
    return Hm


def newton_direction(loss: Loss, w: torch.Tensor, X: torch.Tensor,
                     y: torch.Tensor, l2: float = 0.0,
                     damping: float = 1e-6) -> torch.Tensor:
    """(hess)^-1 grad — the DNSP worker message (Algorithm 6)."""
    p = w.shape[0]
    H = task_hessian(loss, w, X, y, l2) + damping * _eye(p, X)
    g = task_grad(loss, w, X, y, l2)
    return torch.linalg.solve(H, g)


def solve_ridge(X: torch.Tensor, y: torch.Tensor, l2: float) -> torch.Tensor:
    """argmin_w (1/2n)||Xw - y||^2 + (l2/2)||w||^2, closed form."""
    n, p = X.shape
    A = X.T @ X / n + l2 * _eye(p, X)
    b = X.T @ y / n
    return torch.linalg.solve(A, b)


def erm_newton(loss: Loss, X: torch.Tensor, y: torch.Tensor, l2: float = 1e-4,
               iters: int = 25, w0: Optional[torch.Tensor] = None,
               damping: float = 1e-8) -> torch.Tensor:
    """Damped Newton for smooth ERM; exact for squared loss in one step.

    The reference's ``fori_loop`` is a plain loop: PyTorch runs eagerly
    and the iteration count is fixed, so there is nothing to trace.
    """
    p = X.shape[1]
    w = torch.zeros(p, dtype=X.dtype, device=X.device) if w0 is None else w0
    for _ in range(iters):
        g = task_grad(loss, w, X, y, l2)
        H = task_hessian(loss, w, X, y, l2) + damping * _eye(p, X)
        w = w - torch.linalg.solve(H, g)
    return w


def erm(loss: Loss, X: torch.Tensor, y: torch.Tensor, l2: float = 1e-4,
        iters: int = 25) -> torch.Tensor:
    if loss.name == "squared":
        return solve_ridge(X, y, l2)
    return erm_newton(loss, X, y, l2, iters)


def projected_erm(loss: Loss, U: torch.Tensor, X: torch.Tensor, y: torch.Tensor,
                  l2: float = 0.0, iters: int = 25
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The DGSP/DNSP re-fit: v = argmin_v L_nj(U v); returns (w = U v, v).

    Solved exactly in the k-dim subspace via the projected design XU;
    zero-padded columns of ``U`` contribute zero features, so ridge
    still works with a tiny l2 floor.
    """
    XU = X @ U  # (n, k)
    k = XU.shape[1]
    if loss.name == "squared":
        n = X.shape[0]
        A = XU.T @ XU / n + max(l2, 1e-9) * _eye(k, X)
        b = XU.T @ y / n
        v = torch.linalg.solve(A, b)
    else:
        v = erm_newton(loss, XU, y, max(l2, 1e-9), iters)
    return U @ v, v


def project_l2_ball(w: torch.Tensor, radius: float) -> torch.Tensor:
    nrm = torch.linalg.norm(w)
    scale = torch.clamp(radius / torch.clamp(nrm, min=1e-12), max=1.0)
    return w * scale


# Batched (all-tasks) conveniences ------------------------------------------

def all_task_grads(loss: Loss, W: torch.Tensor, Xs: torch.Tensor,
                   ys: torch.Tensor, l2: float = 0.0) -> torch.Tensor:
    """Gradient matrix of the GLOBAL objective: columns (1/m) grad L_nj(w_j).

    W: (p, m); Xs: (m, n, p); ys: (m, n)  ->  (p, m)
    """
    m = W.shape[1]
    per_task = torch.func.vmap(lambda w, X, y: task_grad(loss, w, X, y, l2),
                               in_dims=(1, 0, 0), out_dims=1)
    return per_task(W, Xs, ys) / m


def global_loss(loss: Loss, W: torch.Tensor, Xs: torch.Tensor,
                ys: torch.Tensor, l2: float = 0.0) -> torch.Tensor:
    per_task = torch.func.vmap(lambda w, X, y: task_loss(loss, w, X, y, l2),
                               in_dims=(1, 0, 0))
    return torch.mean(per_task(W, Xs, ys))
