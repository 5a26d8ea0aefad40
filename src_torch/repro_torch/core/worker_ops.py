"""Per-loss dispatch for the worker hot path.

Port of ``repro.core.worker_ops``.  Every round of every gradient-based
solver has each worker evaluate per-task quantities of its local data —
the gradient column ``(1/n) X_j^T l'(X_j w_j)`` above all.  This module
picks the implementation per loss and per device; the three names map
onto the reference's:

* ``gram``   (reference ``gram``) — squared loss with cached per-task
             Gram statistics ``A_j = X_j^T X_j / n``, ``b_j = X_j^T y_j / n``
             (computed once by :meth:`MTLProblem.make`): the gradient is
             ``A_j w_j - b_j``, a batched matmul.  The reference wrote no
             kernel for it, and neither does the port.
* ``kernel`` (reference ``pallas``) — the raw path (logistic, or squared
             without the cache) through
             :func:`repro_torch.kernels.mtl_grad.task_gradients`: the
             hand-written CUDA kernel for a tensor on the card, its plain
             version for a tensor on the CPU.
* ``torch``  (reference ``xla``) — a ``torch.func.vmap`` of
             :mod:`repro_torch.core.linear_model` over the tasks: what a
             CPU tensor gets by default, as the reference's CPU gets
             ``xla``, and the oracle the other two are tested against.

Where the reference asks ``jax.default_backend() == "tpu"``, the port
asks whether the designs lie on a CUDA device.  ``impl=`` still forces
one path.

The stochastic half (DESIGN.md §13) draws seeded mini-batches with
:func:`batch_indices` — the reference's ``jax.random`` fold_in chain,
reproduced bit for bit by :mod:`repro_torch.core.prng` — and builds the
mini-batch messages on them.  Its fused local step
(:func:`minibatch_prox_step_columns`) has two paths: ``kernel``
(reference ``pallas``), the hand-written ``prox_step`` CUDA kernel on
the card, and ``torch`` (reference ``xla``), the historical two-step
expression.

Every function takes the worker-local ``data`` dict the runtime binds
into the round body (``Xs``/``ys`` plus ``gram_A``/``gram_b`` when
cached) and accepts the runtime as ``rt=``.

Data-axis sharding.  Under a 2-D ``("tasks", "data")`` runtime the
``Xs``/``ys`` leaves hold only ``n / data_shards`` rows per task.  With
``rt=`` such a runtime, every raw-path sample statistic is reduced over
the data axis (``rt.pmean_data``: a data-group all-reduce on the mesh,
the emulation's shards meeting under sim): gradients and Hessians are
averaged across shards before any solve, iterative refits reduce once
per Newton step, and the kernels' per-shard outputs are reduced like the
plain path's.  The Gram path needs no reduction: the 2-D runtimes build
the cache as a sum of per-shard partial Grams before the round loop.
``rt=None`` or one data shard keeps the single-shard arithmetic.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

from ..kernels.mtl_grad import task_gradients
from ..kernels.prox_step import prox_step
from . import linear_model as lm
from . import prng
from .losses import Loss

IMPLS = ("gram", "kernel", "torch")


def gram_stats(Xs: torch.Tensor, ys: torch.Tensor, data_shards: int = 1
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-task sufficient statistics for the squared loss.

    Xs: (m, n, p); ys: (m, n)  ->  A (m, p, p), b (m, p) with
    A_j = X_j^T X_j / n and b_j = X_j^T y_j / n, on the designs' device.

    ``data_shards > 1`` computes the same statistics as a sum of
    per-shard partial Grams over contiguous row blocks of n, summed in
    shard order: what the 2-D runtimes build, which agrees with the
    monolithic order only to float rounding.
    """
    n = Xs.shape[1]
    if n % data_shards:
        raise ValueError(f"n={n} not divisible by data_shards={data_shards}")
    rows = n // data_shards
    A, b = shard_gram_stats(Xs[:, :rows], ys[:, :rows], n)
    for s in range(1, data_shards):
        A_s, b_s = shard_gram_stats(Xs[:, s * rows:(s + 1) * rows],
                                    ys[:, s * rows:(s + 1) * rows], n)
        A, b = A + A_s, b + b_s
    return A, b


def shard_gram_stats(Xs: torch.Tensor, ys: torch.Tensor, n: int
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """One shard's partial Gram statistics, normalised by the GLOBAL
    row count ``n`` so that the shards' sum is the task's Gram."""
    return (torch.einsum("jni,jnk->jik", Xs, Xs) / n,
            torch.einsum("jni,jn->ji", Xs, ys) / n)


def has_gram(data: Dict[str, torch.Tensor]) -> bool:
    return "gram_A" in data


def _sharded(rt) -> bool:
    return rt is not None and rt.data_shards > 1


def _pmean(rt, x, note, repeats: int = 1):
    """Average ``x`` over the data axis; identity off the 2-D runtimes."""
    return rt.pmean_data(x, note, repeats=repeats) if _sharded(rt) else x


def _moments(rt, Xs, ys, note) -> Tuple[torch.Tensor, torch.Tensor]:
    """Per-task second moments of (possibly data-sharded) rows:
    A (L, d, d) = X^T X / n, b (L, d) = X^T y / n — each shard's
    statistics over its local rows, pmean-reduced over the data axis.
    The one reduction every closed-form sharded solve goes through."""
    A, b = shard_gram_stats(Xs, ys, Xs.shape[1])
    return _pmean(rt, A, note + " gram shards"), \
        _pmean(rt, b, note + " Xty shards")


def _solve_cols(H: torch.Tensor, g: torch.Tensor, shift) -> torch.Tensor:
    """Per-task ``(H_j + shift I)^-1 g_j``: H (L, d, d), g (d, L) ->
    (d, L)."""
    eye = torch.eye(H.shape[-1], dtype=H.dtype, device=H.device)
    return _per_task(lambda Hj, gj: torch.linalg.solve(Hj + shift * eye, gj),
                     (0, 1))(H, g)


def _per_task(fn, in_dims, out_dims=1):
    return torch.func.vmap(fn, in_dims=in_dims, out_dims=out_dims)


def _grad_hess(loss: Loss, W_cols: torch.Tensor, Xs: torch.Tensor,
               ys: torch.Tensor, l2: float
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Stacked per-task gradient (d, L) and Hessian (L, d, d)."""
    g = _per_task(lambda w, X, y: lm.task_grad(loss, w, X, y, l2),
                  (1, 0, 0))(W_cols, Xs, ys)
    H = _per_task(lambda w, X, y: lm.task_hessian(loss, w, X, y, l2),
                  (1, 0, 0), 0)(W_cols, Xs, ys)
    return g, H


def _resolve_impl(loss: Loss, data: Dict[str, torch.Tensor],
                  impl: Optional[str]) -> str:
    if impl is not None:
        return impl
    if loss.name == "squared" and has_gram(data):
        return "gram"
    if data["Xs"].device.type == "cuda" and loss.name in ("squared",
                                                          "logistic"):
        return "kernel"
    return "torch"


def grad_columns(loss: Loss, W_cols: torch.Tensor,
                 data: Dict[str, torch.Tensor], l2: float = 0.0,
                 impl: Optional[str] = None, rt=None) -> torch.Tensor:
    """Per-task gradient columns ``grad L_nj(w_j)``: (p, L) from (p, L).

    Callers apply the global objective's 1/m factor themselves.  ``impl``
    forces an implementation ("gram" | "kernel" | "torch"); by default
    the cheapest correct one for the loss and the device is picked.
    """
    impl = _resolve_impl(loss, data, impl)
    if impl == "gram":
        G = torch.einsum("jik,kj->ij", data["gram_A"], W_cols) \
            - data["gram_b"].T
    elif impl == "kernel":
        G = task_gradients(data["Xs"], data["ys"], W_cols.T.contiguous(),
                           loss=loss.name).T.to(W_cols.dtype)
        G = _pmean(rt, G, "gradient shards")
    elif impl == "torch":
        G = _per_task(lambda w, X, y: lm.task_grad(loss, w, X, y),
                      (1, 0, 0))(W_cols, data["Xs"], data["ys"])
        G = _pmean(rt, G, "gradient shards")
    else:
        raise ValueError(f"unknown gradient impl {impl!r}; have {IMPLS}")
    if l2:
        G = G + l2 * W_cols
    return G


# ---------------------------------------------------------------------------
# stochastic worker path (DESIGN.md §13): a seeded batch sampler + the
# mini-batch gradient/Newton messages built on it
# ---------------------------------------------------------------------------
def batch_indices(seed: int, task_ids: torch.Tensor, round_k: int,
                  local_step: int, batch_size: int, n_local: int,
                  shard: int = 0) -> torch.Tensor:
    """Per-task mini-batch row indices ``(L, batch_size)`` int32 into
    ``n_local`` local rows, on ``task_ids``' device.

    Each task's key is the reference's fold_in chain over ``(seed,
    global task id, round, local step, data-shard index)``, so the rows
    are the reference's rows, draw for draw, on any device.
    ``batch_size == n_local`` returns ``arange(n_local)`` — the natural
    row order, so the degenerate mini-batch is the full batch in the
    same order.  Smaller batches sample WITH replacement.
    """
    B, n_local = int(batch_size), int(n_local)
    L = task_ids.shape[0]
    dev = task_ids.device
    if B == n_local:
        return torch.arange(n_local, dtype=torch.int32,
                            device=dev).expand(L, n_local)
    key = prng.fold_in(prng.PRNGKey(seed, device=dev), task_ids)
    key = prng.fold_in(key, round_k)
    key = prng.fold_in(key, local_step)
    key = prng.fold_in(key, shard)
    return prng.randint(key, (B,), 0, n_local)


def _sample_batch(data: Dict[str, torch.Tensor], rt, seed: int,
                  round_k: int, local_step: int, batch_size: int
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Gather one seeded mini-batch ``(Xb (L, B_loc, p), yb (L, B_loc))``
    from the worker-local rows.  ``batch_size`` is the GLOBAL per-task
    batch; each data shard draws ``batch_size / data_shards`` of its
    local rows under its own folded shard index."""
    Xs, ys = data["Xs"], data["ys"]
    D = rt.data_shards if rt is not None else 1
    idx = batch_indices(seed, data["task_ids"], round_k, local_step,
                        batch_size // D, Xs.shape[1],
                        shard=rt.data_index() if rt is not None else 0
                        ).long()
    rows = torch.arange(Xs.shape[0], device=Xs.device)[:, None]
    return Xs[rows, idx], ys[rows, idx]


def minibatch_grad_columns(loss: Loss, W_cols: torch.Tensor,
                           data: Dict[str, torch.Tensor], l2: float = 0.0,
                           rt=None, *, seed: int, round_k: int,
                           local_step: int, batch_size: int
                           ) -> torch.Tensor:
    """Per-task MINI-BATCH gradient columns (p, L): the ``torch`` gradient
    on a seeded batch of sampled rows (the reference never routes it
    through a kernel either).  Callers apply the 1/m factor."""
    Xb, yb = _sample_batch(data, rt, seed, round_k, local_step, batch_size)
    G = _per_task(lambda w, X, y: lm.task_grad(loss, w, X, y),
                  (1, 0, 0))(W_cols, Xb, yb)
    G = _pmean(rt, G, "minibatch gradient shards")
    if l2:
        G = G + l2 * W_cols
    return G


def _resolve_step_impl(loss: Loss, data: Dict[str, torch.Tensor],
                       impl: Optional[str]) -> str:
    """The fused prox step has no Gram path (it runs on sampled rows):
    the kernel for squared/logistic designs on the card, else torch."""
    if impl is not None:
        return impl
    if data["Xs"].device.type == "cuda" and loss.name in ("squared",
                                                          "logistic"):
        return "kernel"
    return "torch"


def minibatch_prox_step_columns(loss: Loss, W_cols: torch.Tensor,
                                data: Dict[str, torch.Tensor],
                                l2: float = 0.0, rt=None, *, seed: int,
                                round_k: int, local_step: int,
                                batch_size: int, eta, m: int, Z_cols=None,
                                Q_cols=None, rho=0.0,
                                impl: Optional[str] = None) -> torch.Tensor:
    """One fused prox-family local step on a seeded mini-batch:

        W <- W - eta (G/m + Q + rho (W - Z)),   G the mini-batch
                                                 gradient (+ l2 W)

    ``Q_cols=None`` is the plain-descent case (ProxGD/AccProxGD pass
    ``eta * m`` so the 1/m cancels).

    * ``torch``  — :func:`minibatch_grad_columns` then the step, the
                   reference's historical expression in its order; with
                   ``Q_cols=None`` the rho/Z terms are skipped, not
                   multiplied by zero.
    * ``kernel`` — :func:`repro_torch.kernels.prox_step.prox_step`:
                   gradient and step in one launch on the card, the
                   (L, p) gradient never reaching device memory.  It
                   gets ``Z=W``, ``Q=0`` and ``inv_m=1/m`` in the
                   plain-descent case, as the reference's Pallas branch.

    Under 2-D sharding the kernel path pmean-reduces the STEPPED columns
    instead of the gradient: the update is affine in G with W/Z/Q the
    same on every shard, so the average commutes (the reference's rule).
    """
    impl = _resolve_step_impl(loss, data, impl)
    if impl == "torch":
        G = minibatch_grad_columns(loss, W_cols, data, l2, rt=rt, seed=seed,
                                   round_k=round_k, local_step=local_step,
                                   batch_size=batch_size)
        if Q_cols is None:
            return W_cols - eta * (G / m)
        return W_cols - eta * (G / m + Q_cols + rho * (W_cols - Z_cols))
    if impl != "kernel":
        raise ValueError(f"unknown prox step impl {impl!r}; "
                         "have 'kernel', 'torch'")
    Xb, yb = _sample_batch(data, rt, seed, round_k, local_step, batch_size)
    W = W_cols.T.contiguous()
    Z = W if Z_cols is None else Z_cols.T.contiguous()
    Q = torch.zeros_like(W) if Q_cols is None else Q_cols.T.contiguous()
    W_new = prox_step(Xb, yb, W, Z, Q, eta=eta, rho=rho,
                      inv_m=1.0 / m, l2=l2, loss=loss.name)
    return _pmean(rt, W_new.T.to(W_cols.dtype), "minibatch gradient shards")


def minibatch_newton_columns(loss: Loss, W_cols: torch.Tensor,
                             data: Dict[str, torch.Tensor], l2: float = 0.0,
                             damping: float = 1e-6, rt=None, *, seed: int,
                             round_k: int, local_step: int, batch_size: int
                             ) -> torch.Tensor:
    """DNSP's stochastic worker messages: the Newton direction of the
    MINI-BATCH objective, gradient and Hessian on the same seeded batch
    (each pmean-reduced over the data axis before the solve)."""
    Xb, yb = _sample_batch(data, rt, seed, round_k, local_step, batch_size)
    g, H = _grad_hess(loss, W_cols, Xb, yb, l2)
    g = _pmean(rt, g, "minibatch newton grad shards")
    H = _pmean(rt, H, "minibatch newton hess shards")
    return _solve_cols(H, g, damping)


def newton_columns(loss: Loss, W_cols: torch.Tensor,
                   data: Dict[str, torch.Tensor], l2: float = 0.0,
                   damping: float = 1e-6, rt=None) -> torch.Tensor:
    """DNSP worker messages ``(hess L_nj)^-1 grad L_nj``: (p, L).

    Squared loss with Gram cache: the Hessian IS ``A_j`` — one (p, p)
    solve per task, no pass over the raw data.  Raw path under a 2-D
    runtime: per-shard gradients and Hessians are pmean-reduced BEFORE
    the solve (the direction is nonlinear in the data).
    """
    if loss.name == "squared" and has_gram(data):
        p = W_cols.shape[0]
        eye = torch.eye(p, dtype=W_cols.dtype, device=W_cols.device)

        def one(A, b, w):
            g = A @ w - b + l2 * w
            return torch.linalg.solve(A + (l2 + damping) * eye, g)

        return _per_task(one, (0, 0, 1))(data["gram_A"], data["gram_b"],
                                         W_cols)
    if _sharded(rt):
        g, H = _grad_hess(loss, W_cols, data["Xs"], data["ys"], l2)
        g = rt.pmean_data(g, "newton grad shards")
        H = rt.pmean_data(H, "newton hess shards")
        return _solve_cols(H, g, damping)
    return _per_task(
        lambda w, X, y: lm.newton_direction(loss, w, X, y, l2, damping),
        (1, 0, 0))(W_cols, data["Xs"], data["ys"])


def ridge_columns(data: Dict[str, torch.Tensor], l2: float) -> torch.Tensor:
    """Per-task ridge solutions (p, L) from the Gram cache (squared loss)."""
    A, b = data["gram_A"], data["gram_b"]
    eye = torch.eye(A.shape[-1], dtype=A.dtype, device=A.device)
    return _per_task(lambda Aj, bj: torch.linalg.solve(Aj + l2 * eye, bj),
                     (0, 0))(A, b)


def _newton_cols(loss: Loss, Xs: torch.Tensor, ys: torch.Tensor, l2: float,
                 iters: int, rt, damping: float = 1e-8) -> torch.Tensor:
    """Stacked damped-Newton ERM over data-sharded rows.

    Xs: (L, n_loc, d); ys: (L, n_loc) -> V (d, L), from V = 0.  The
    data-axis reduction happens once per Newton step (gradient and
    Hessian), each call charged once as it runs.
    """
    L, _, d = Xs.shape
    V = torch.zeros((d, L), dtype=Xs.dtype, device=Xs.device)
    for _ in range(iters):
        g, H = _grad_hess(loss, V, Xs, ys, l2)
        g = _pmean(rt, g, "erm newton grad")
        H = _pmean(rt, H, "erm newton hess")
        V = V - _solve_cols(H, g, damping)
    return V


def erm_columns(loss: Loss, data: Dict[str, torch.Tensor], l2: float,
                rt=None, iters: int = 25) -> torch.Tensor:
    """Per-task unconstrained ERM solutions (p, L) — the Local baseline's
    worker computation: one ridge solve per task from the Gram cache
    when present, else ``linear_model.erm`` per task (closed form for
    the squared loss, damped Newton otherwise).  Under a 2-D runtime
    the raw paths reduce their moments (squared) or each Newton step
    over the data axis."""
    if loss.name == "squared" and has_gram(data):
        return ridge_columns(data, l2)
    Xs, ys = data["Xs"], data["ys"]
    if not _sharded(rt):
        return _per_task(lambda X, y: lm.erm(loss, X, y, l2, iters),
                         (0, 0))(Xs, ys)
    if loss.name == "squared":
        A, b = _moments(rt, Xs, ys, "erm")
        return _solve_cols(A, b.T, l2)
    return _newton_cols(loss, Xs, ys, l2, iters, rt)


def prox_columns(loss: Loss, data: Dict[str, torch.Tensor],
                 Z_cols: torch.Tensor, Q_cols: torch.Tensor,
                 W0_cols: torch.Tensor, rho: float, m: int, l2: float = 0.0,
                 iters: int = 8, rt=None) -> torch.Tensor:
    """The ADMM worker step (Appendix A.1), per task:

        w_j+ = argmin_w  L_nj(w)/m + <w - z_j, q_j> + rho/2 ||w - z_j||^2

    Z_cols/Q_cols/W0_cols: (p, L) -> (p, L).  Squared loss: closed form
    (from the Gram cache when present, else from the raw moments).
    Smooth non-quadratic losses: ``iters`` damped Newton steps on the
    strongly convex subproblem.
    """
    p = Z_cols.shape[0]
    eye = torch.eye(p, dtype=Z_cols.dtype, device=Z_cols.device)
    if loss.name == "squared":
        if has_gram(data):
            A, b = data["gram_A"], data["gram_b"]
        else:
            A, b = _moments(rt, data["Xs"], data["ys"], "prox")

        def one(Aj, bj, z, q):
            Amat = Aj / m + (rho + l2 / m) * eye
            return torch.linalg.solve(Amat, bj / m + rho * z - q)

        return _per_task(one, (0, 0, 1, 1))(A, b, Z_cols, Q_cols)

    Xs, ys = data["Xs"], data["ys"]
    W = W0_cols
    for _ in range(iters):
        g, H = _grad_hess(loss, W, Xs, ys, l2)
        g = _pmean(rt, g, "prox newton grad")
        H = _pmean(rt, H, "prox newton hess")
        g = g / m + Q_cols + rho * (W - Z_cols)
        step = _per_task(lambda Hj, gj: torch.linalg.solve(Hj / m + rho * eye,
                                                           gj),
                         (0, 1))(H, g)
        W = W - step
    return W


def projected_solves(loss: Loss, U: torch.Tensor,
                     data: Dict[str, torch.Tensor], l2: float = 0.0,
                     iters: int = 25, rt=None
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The DGSP/DNSP re-fit ``v_j = argmin_v L_nj(U v)``.

    Returns (W_cols (p, L), V (k, L)) with ``W = U V``.  Squared loss
    with Gram cache: the projected normal equations
    ``U^T A_j U v = U^T b_j`` — cost k^2 p per task instead of n p k.
    """
    if loss.name == "squared" and has_gram(data):
        k = U.shape[1]
        eye = torch.eye(k, dtype=U.dtype, device=U.device)

        def one(A, b):
            Ak = U.T @ (A @ U) + max(l2, 1e-9) * eye
            return torch.linalg.solve(Ak, U.T @ b)

        V = _per_task(one, (0, 0))(data["gram_A"], data["gram_b"])
        return U @ V, V

    if _sharded(rt):
        # project the LOCAL rows (X_j U on the shard) and reduce the
        # k-dimensional normal equations, or each Newton step
        XU = torch.matmul(data["Xs"], U)                 # (L, n_loc, k)
        if loss.name == "squared":
            Ak, bk = _moments(rt, XU, data["ys"], "projected")
            V = _solve_cols(Ak, bk.T, max(l2, 1e-9))
        else:
            V = _newton_cols(loss, XU, data["ys"], max(l2, 1e-9), iters, rt)
        return U @ V, V

    return _per_task(lambda X, y: lm.projected_erm(loss, U, X, y, l2, iters),
                     (0, 0), (1, 1))(data["Xs"], data["ys"])
