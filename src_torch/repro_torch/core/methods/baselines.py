"""One-shot baselines: Local, Centralize, BestRep, one-shot SVD truncation.

Port of ``repro.core.methods.baselines``.  These are the brackets the
iterative methods are measured against (Propositions 2.2 / 2.5 and the
§5 "One-shot SVD truncation" discussion), written against the runtime
primitives like the iterative solvers.
"""
from __future__ import annotations

import math

import torch

from .. import linear_model as lm
from .. import spectral, worker_ops
from ..svd_ops import svd_truncate
from .base import (MTLProblem, MTLResult, default_runtime, gram_round_leaves,
                   register)


def _local_columns(prob: MTLProblem, data, l2: float, rt=None) -> torch.Tensor:
    """Worker-local constrained ERM columns (p, L): solve (Prop 2.2),
    then project to the A-ball."""
    W = worker_ops.erm_columns(prob.loss, data, l2, rt=rt)
    return torch.func.vmap(lambda w: lm.project_l2_ball(w, prob.A),
                           in_dims=1, out_dims=1)(W)


def _local_W(prob: MTLProblem, l2: float) -> torch.Tensor:
    """Host-side Local solution (used as an init by the convex solvers)."""
    return _local_columns(prob, prob.worker_data(), l2)


def _zeros_W(prob: MTLProblem) -> torch.Tensor:
    return torch.zeros((prob.p, prob.m), dtype=prob.Xs.dtype,
                       device=prob.device)


@register("local")
def local(prob: MTLProblem, l2: float = 1e-6, runtime=None,
          scan: bool = True, **_) -> MTLResult:
    """Per-machine ERM; zero communication."""
    rt = default_runtime(prob, runtime)
    l2 = max(l2, prob.l2)

    def body(k, state, data):
        return {"W": _local_columns(prob, data, l2, rt=rt)}

    state = rt.one_shot(body, {"W": _zeros_W(prob)}, sharded=("W",),
                        count_round=False, scan=scan,
                        data_leaves=gram_round_leaves(prob))
    res = MTLResult("local", state["W"], rt.comm)
    res.record(0, state["W"])
    return res


@register("svd_trunc")
def svd_trunc(prob: MTLProblem, l2: float = 1e-6, rank: int | None = None,
              runtime=None, scan: bool = True, sv_engine: str = "lazy",
              **_) -> MTLResult:
    """One-shot SVD truncation of the Local solution (§5): each worker
    ships its local w_hat (1 p-vector), the master truncates to rank r
    (``spectral.truncate``, or the exact SVD) and ships each column back
    (1 p-vector)."""
    rt = default_runtime(prob, runtime)
    l2 = max(l2, prob.l2)
    r = int(rank if rank is not None else prob.r)
    if sv_engine not in ("lazy", "exact"):
        raise ValueError(
            f"unknown sv_engine {sv_engine!r}; have 'lazy', 'exact'")
    lazy = sv_engine == "lazy"

    def body(k, state, data):
        W_local = _local_columns(prob, data, l2, rt=rt)
        W_full = rt.gather_columns(W_local, "local solution")
        W_t = spectral.truncate(W_full, r) if lazy \
            else svd_truncate(W_full, r)
        return {"W": rt.broadcast(W_t, "truncated column")}

    state = rt.one_shot(body, {"W": _zeros_W(prob)}, scan=scan,
                        data_leaves=gram_round_leaves(prob))
    res = MTLResult("svd_trunc", state["W"], rt.comm)
    res.record(1, state["W"])
    return res


@register("bestrep")
def bestrep(prob: MTLProblem, U_star=None, runtime=None,
            scan: bool = True, **_) -> MTLResult:
    """Oracle: fit in the TRUE subspace U* (not realizable in practice)."""
    if U_star is None:
        raise ValueError("bestrep needs the oracle U_star")
    rt = default_runtime(prob, runtime)
    U_star = torch.as_tensor(U_star, dtype=prob.Xs.dtype, device=prob.device)

    def body(k, state, data):
        W, _ = worker_ops.projected_solves(prob.loss, U_star, data, prob.l2,
                                           rt=rt)
        return {"W": W}

    state = rt.one_shot(body, {"W": _zeros_W(prob)}, sharded=("W",),
                        count_round=False, scan=scan,
                        data_leaves=gram_round_leaves(prob))
    res = MTLResult("bestrep", state["W"], rt.comm)
    res.record(0, state["W"])
    return res


@register("centralize")
def centralize(prob: MTLProblem, lam: float = None, iters: int = 400,
               tol: float = 1e-9, runtime=None, scan: bool = True,
               sv_engine: str = "lazy", sv_rank: int = None,
               **_) -> MTLResult:
    """Nuclear-norm regularized ERM with all data on the master (eq. 2.3).

    Solved with ``iters`` FISTA steps (accelerated prox gradient, a
    plain loop); the charge is the one-time shipment of the n local
    samples per machine (row and label as n (p+1)-vectors).  The
    gradient is ``linear_model.all_task_grads`` in plain torch, as in
    the reference; the prox steps run on the spectral engine, warm
    across iterations.
    """
    rt = default_runtime(prob, runtime)
    loss, m, p = prob.loss, prob.m, prob.p
    if lam is None:
        # heuristic in the scale of the gradient spectral norm
        lam = 0.1 / math.sqrt(prob.n * m)
    from .convex import data_smoothness
    eta = 1.0 / data_smoothness(prob)
    sv = spectral.shrink_engine(prob, sv_engine, rank=sv_rank)

    def body(k, state, data):
        Xs, ys = data["Xs"], data["ys"]
        Xy = torch.cat([Xs, ys[..., None]], dim=-1)           # (L, n, p+1)
        Xy = rt.gather_samples(Xy, axis=1, note="sample shards")
        Xy = rt.gather_tasks(Xy, "ship all local data")       # (m, n, p+1)
        Xs_full, ys_full = Xy[..., :-1], Xy[..., -1]
        W = Z = torch.zeros((p, m), dtype=Xs.dtype, device=Xs.device)
        t = torch.tensor(1.0, dtype=Xs.dtype, device=Xs.device)
        svc, nn = sv.init_carry(), torch.zeros((), dtype=Xs.dtype,
                                               device=Xs.device)
        for _ in range(iters):
            G = lm.all_task_grads(loss, Z, Xs_full, ys_full, prob.l2)
            W_new, nn, svc = sv.shrink(Z - eta * m * G, eta * m * lam, svc)
            t_new = 0.5 * (1.0 + torch.sqrt(1.0 + 4.0 * t * t))
            Z = W_new + ((t - 1.0) / t_new) * (W_new - W)
            W, t = W_new, t_new
        return {"W": rt.broadcast(W, "final predictor"), "nn": nn}

    state = rt.one_shot(body, {"W": _zeros_W(prob),
                               "nn": torch.zeros((), dtype=prob.Xs.dtype,
                                                 device=prob.device)},
                        scan=scan)
    W = state["W"]
    res = MTLResult("centralize", W, rt.comm,
                    extras={"lam": float(lam), "sv_engine": sv.mode,
                            "nuclear_norm": float(state["nn"])})
    res.record(1, W)
    return res
