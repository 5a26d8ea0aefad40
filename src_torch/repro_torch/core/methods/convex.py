"""Distributed convex-optimization methods over the nuclear-norm objective.

Port of ``repro.core.methods.convex``.

ProxGD   (Algorithm 4): workers send gradient columns; master does
                        singular-value shrinkage.         2p per round.
AccProxGD (Algorithm 5): Nesterov two-sequence variant.   2p per round.
ADMM     (Algorithm 2 / Appendix A): workers solve regularized local ERM;
                        master shrinkage + dual update.   3p per round.
DFW      (Algorithm 3 / Appendix B): master computes only the LEADING
                        singular pair of the gradient.    2p per round.

Each solver is a round body against the runtime primitives: workers
compute on their task columns through :mod:`repro_torch.core.worker_ops`
(the Gram path for the squared loss, the ``mtl_grad`` kernel for raw
gradients on the card), the gradient matrix is assembled with
gather_columns, the master step runs on the gathered state, and
broadcast publishes the update.  The shrinkage masters run on the
spectral engine (``sv_engine="lazy"`` by default), whose basis carry
rides in the solver state.

ProxGD, AccProxGD and ADMM also take the stochastic worker path
(``batch_size``/``local_steps``, DESIGN.md §13): each round, ``L``
communication-free local steps on seeded mini-batches through
``worker_ops.minibatch_prox_step_columns`` (the ``prox_step`` kernel on
the card), then the one charged exchange of Table 1.
"""
from __future__ import annotations

import math

import torch

from .. import spectral, worker_ops
from ..spectral import leading_sv
from ...obs.device import obs_round
from .base import (MTLProblem, MTLResult, compose_records, default_runtime,
                   gram_round_leaves, iterate_recorder, metrics_channel,
                   register, stamp_sgd, stochastic_config,
                   stochastic_round_leaves)


def _power_lmax(op, m: int, p: int, like: torch.Tensor) -> torch.Tensor:
    """Largest eigenvalue over tasks of a per-task PSD operator
    ``op: (m, p) -> (m, p)``: 50 normalized power steps from the flat
    start, then the Rayleigh quotient."""
    v = torch.ones((m, p), dtype=like.dtype, device=like.device) / math.sqrt(p)
    for _ in range(50):
        w = op(v)
        v = w / torch.clamp(torch.linalg.norm(w, dim=1, keepdim=True),
                            min=1e-30)
    return torch.max(torch.sum(v * op(v), dim=1))


def data_smoothness(prob: MTLProblem) -> float:
    """Per-task smoothness H * max_j ||X_j^T X_j / n||_2.

    Uses the cached Gram matrices when present; otherwise matvecs on the
    implicit Gram operator v -> X^T (X v) / n, which never materializes
    the (p, p) per-task Gram (m p^2 floats: 12 GB at p=2048, m=768).
    """
    m, p = prob.m, prob.p
    if prob.gram_A is not None:
        A = prob.gram_A
        lmax = _power_lmax(lambda v: torch.einsum("jik,jk->ji", A, v),
                           m, p, A)
    else:
        Xs, n = prob.Xs, prob.n
        lmax = _power_lmax(
            lambda v: torch.einsum("jni,jn->ji", Xs,
                                   torch.einsum("jni,ji->jn", Xs, v)) / n,
            m, p, Xs)
    return float(prob.loss.smoothness * lmax)


def _init_W(prob: MTLProblem, init: str, init_W=None) -> torch.Tensor:
    if init_W is not None:
        # an explicit (p, m) warm start; worker-local state, no traffic
        init_W = torch.as_tensor(init_W, dtype=prob.Xs.dtype,
                                 device=prob.device)
        if tuple(init_W.shape) != (prob.p, prob.m):
            raise ValueError(f"init_W shape {tuple(init_W.shape)} != "
                             f"{(prob.p, prob.m)}")
        return init_W
    if init == "zeros":
        return torch.zeros((prob.p, prob.m), dtype=prob.Xs.dtype,
                           device=prob.device)
    if init == "local":
        # Paper §5: "For ProxGD and AccProxGD, we initialized from Local."
        from .baselines import _local_W
        return _local_W(prob, max(prob.l2, 1e-6))
    raise ValueError(init)


def _sv_carry0(sv, sv_carry):
    """The spectral engine's initial carry: a fresh cold probe, or the
    carry a previous solve of the SAME (m, rank) geometry finished with
    (``keep_sv_carry=True``)."""
    cold = sv.init_carry()
    if sv_carry is None:
        return cold
    if set(sv_carry) != set(cold) or any(
            tuple(sv_carry[k].shape) != tuple(cold[k].shape)
            for k in ("V", "s", "T") if k in cold):
        raise ValueError("sv_carry does not match this solve's spectral "
                         "engine (engine mode or rank differ)")
    return sv_carry


def _grad_columns(rt, prob, Z, data, note):
    """Workers differentiate their local columns of Z; master gathers."""
    Z_local = rt.local_slice(Z)
    G_local = worker_ops.grad_columns(prob.loss, Z_local, data,
                                      prob.l2, rt=rt) / prob.m
    return rt.gather_columns(G_local, note)


def _round_leaves(prob, sgd):
    return gram_round_leaves(prob) if sgd is None \
        else stochastic_round_leaves(prob)


def _finish(res, sv, state, keep_sv_carry, rt=None, mc=None):
    res.extras.update(sv.stats(state["sv"]))
    if mc is not None:
        res.extras["metrics"] = mc[2].finalize(rt)
    if keep_sv_carry:
        res.extras["sv_carry"] = state["sv"]
    return res


@register("proxgd")
def proxgd(prob: MTLProblem, lam: float = 1e-3, rounds: int = 200,
           eta: float = None, init: str = "local", record_every: int = 1,
           runtime=None, scan: bool = True, sv_engine: str = "lazy",
           sv_rank: int = None, batch_size: int = None,
           local_steps: int = None, batch_seed: int = 0, init_W=None,
           sv_carry=None, keep_sv_carry: bool = False,
           metrics: bool = False, **_) -> MTLResult:
    rt = default_runtime(prob, runtime)
    if eta is None:
        eta = 1.0 / data_smoothness(prob)
    m = prob.m
    sv = spectral.shrink_engine(prob, sv_engine, rank=sv_rank)
    sgd = stochastic_config(prob, batch_size, local_steps, rt.data_shards)
    mc = metrics_channel(metrics, prob)

    def master(state, M, G):
        W_new, nn, svc = sv.shrink(M, eta * m * lam, state["sv"])
        out = {"W": rt.broadcast(W_new, "updated predictor"), "sv": svc}
        if metrics:
            # no full-batch gradient in a stochastic round (G is None)
            out["obs"] = obs_round(state["W"], W_new, grad=G,
                                   objective=lam * nn,
                                   sv_stats=sv.device_stats(svc))
        return out

    if sgd is None:
        def body(k, state, data):
            G = _grad_columns(rt, prob, state["W"], data, "gradient column")
            # master prox step (3.3); grad of (1/m)sum L_nj carries 1/m,
            # the per-task smoothness is H/m so the per-W step uses eta*m
            return master(state, state["W"] - eta * m * G, G)
    else:
        B, L = sgd

        def body(k, state, data):
            # L communication-free local steps on the worker's own task
            # columns (arXiv 1802.03830); the master shrinks the gathered
            # locally stepped columns — the one charged exchange
            Wl = rt.local_slice(state["W"])
            for i in range(L):
                Wl = worker_ops.minibatch_prox_step_columns(
                    prob.loss, Wl, data, prob.l2, rt=rt, seed=batch_seed,
                    round_k=k, local_step=i, batch_size=B, eta=eta * m,
                    m=m)
            W_gath = rt.gather_columns(Wl, "locally stepped columns")
            return master(state, W_gath, None)

    state = {"W": _init_W(prob, init, init_W),
             "sv": _sv_carry0(sv, sv_carry)}
    if mc is not None:
        state["obs"] = mc[0]
    res = MTLResult("proxgd", state["W"], rt.comm,
                    extras={"lam": lam, "eta": eta, "sv_engine": sv.mode})
    stamp_sgd(res, sgd)
    res.record(0, state["W"])
    state = rt.run_rounds(rounds, body, state, scan=scan,
                          record=compose_records(
                              iterate_recorder(res, record_every), mc),
                          data_leaves=_round_leaves(prob, sgd))
    res.W = state["W"]
    return _finish(res, sv, state, keep_sv_carry, rt, mc)


@register("accproxgd")
def accproxgd(prob: MTLProblem, lam: float = 1e-3, rounds: int = 200,
              eta: float = None, init: str = "local", record_every: int = 1,
              runtime=None, scan: bool = True, sv_engine: str = "lazy",
              sv_rank: int = None, batch_size: int = None,
              local_steps: int = None, batch_seed: int = 0, init_W=None,
              sv_carry=None, keep_sv_carry: bool = False,
              metrics: bool = False, **_) -> MTLResult:
    rt = default_runtime(prob, runtime)
    if eta is None:
        eta = 1.0 / data_smoothness(prob)
    m = prob.m
    sv = spectral.shrink_engine(prob, sv_engine, rank=sv_rank)
    sgd = stochastic_config(prob, batch_size, local_steps, rt.data_shards)
    mc = metrics_channel(metrics, prob)

    def master(state, Z_stepped, G):
        W, t = state["W"], state["t"]
        W_new, nn, svc = sv.shrink(Z_stepped, eta * m * lam,
                                   state["sv"])                  # (3.4)
        t_new = 0.5 * (1.0 + torch.sqrt(1.0 + 4.0 * t * t))
        Z_new = W_new + ((t - 1.0) / t_new) * (W_new - W)        # (3.5)
        out = {"W": W_new, "Z": rt.broadcast(Z_new, "updated Z column"),
               "t": t_new, "sv": svc}
        if metrics:
            out["obs"] = obs_round(W, W_new, grad=G, objective=lam * nn,
                                   sv_stats=sv.device_stats(svc))
        return out

    if sgd is None:
        def body(k, state, data):
            Z = state["Z"]
            G = _grad_columns(rt, prob, Z, data, "gradient at Z")
            return master(state, Z - eta * m * G, G)
    else:
        B, L = sgd

        def body(k, state, data):
            # local steps descend the momentum sequence Z's columns (the
            # point (3.4) evaluates the gradient at); the master shrinks
            # the gathered locally stepped columns
            Zl = rt.local_slice(state["Z"])
            for i in range(L):
                Zl = worker_ops.minibatch_prox_step_columns(
                    prob.loss, Zl, data, prob.l2, rt=rt, seed=batch_seed,
                    round_k=k, local_step=i, batch_size=B, eta=eta * m,
                    m=m)
            Z_stepped = rt.gather_columns(Zl, "locally stepped Z columns")
            return master(state, Z_stepped, None)

    W0 = _init_W(prob, init, init_W)
    state = {"W": W0, "Z": W0,
             "t": torch.tensor(1.0, dtype=W0.dtype, device=W0.device),
             "sv": _sv_carry0(sv, sv_carry)}
    if mc is not None:
        state["obs"] = mc[0]
    res = MTLResult("accproxgd", state["W"], rt.comm,
                    extras={"lam": lam, "eta": eta, "sv_engine": sv.mode})
    stamp_sgd(res, sgd)
    res.record(0, state["W"])
    state = rt.run_rounds(rounds, body, state, scan=scan,
                          record=compose_records(
                              iterate_recorder(res, record_every), mc),
                          data_leaves=_round_leaves(prob, sgd))
    res.W = state["W"]
    return _finish(res, sv, state, keep_sv_carry, rt, mc)


@register("admm")
def admm(prob: MTLProblem, lam: float = 1e-3, rho: float = 1.0,
         rounds: int = 200, record_every: int = 1, newton_iters: int = 8,
         runtime=None, scan: bool = True, sv_engine: str = "lazy",
         sv_rank: int = None, batch_size: int = None,
         local_steps: int = None, batch_seed: int = 0,
         sv_carry=None, keep_sv_carry: bool = False,
         metrics: bool = False, **_) -> MTLResult:
    """Appendix A. Worker step (A.1) is a regularized ERM:
        w_j+ = argmin_w L_nj(w)/m + <w - z_j, q_j> + rho/2 ||w - z_j||^2,
    dispatched by ``worker_ops.prox_columns`` (closed form for the
    squared loss, ``newton_iters`` Newton steps otherwise).

    Stochastic path (``batch_size``/``local_steps``): the (A.1) solve
    becomes ``local_steps`` prox-gradient steps on the same augmented
    Lagrangian, each on a seeded mini-batch — an inexact-ADMM worker,
    still 3 charged vectors per round."""
    rt = default_runtime(prob, runtime)
    loss, m, p = prob.loss, prob.m, prob.p
    sv = spectral.shrink_engine(prob, sv_engine, rank=sv_rank)
    sgd = stochastic_config(prob, batch_size, local_steps, rt.data_shards)
    mc = metrics_channel(metrics, prob)
    if sgd is not None:
        B, L = sgd
        # the augmented Lagrangian's per-column smoothness: the data
        # smoothness of L_nj/m plus the rho-quadratic's curvature
        eta_w = 1.0 / (data_smoothness(prob) / m + rho)

    def worker(k, W_local, z_loc, q_loc, data):
        if sgd is None:
            return worker_ops.prox_columns(loss, data, z_loc, q_loc,
                                           W_local, rho, m, prob.l2,
                                           iters=newton_iters, rt=rt)
        for i in range(L):
            W_local = worker_ops.minibatch_prox_step_columns(
                loss, W_local, data, prob.l2, rt=rt, seed=batch_seed,
                round_k=k, local_step=i, batch_size=B, eta=eta_w, m=m,
                Z_cols=z_loc, Q_cols=q_loc, rho=rho)
        return W_local

    def body(k, state, data):
        W_local, Z, Q = state["W"], state["Z"], state["Q"]
        z_loc, q_loc = rt.local_slice(Z), rt.local_slice(Q)
        W_local = worker(k, W_local, z_loc, q_loc, data)
        W_full = rt.gather_columns(W_local, "local w")
        Z_new, nn, svc = sv.shrink(W_full + Q / rho, lam / rho,
                                   state["sv"])                  # (A.2)
        Q_new = Q + rho * (W_full - Z_new)                       # (A.3)
        # the fused step on the card hands back a transposed view; the
        # carry keeps one layout (the next step reads it through
        # ``.T.contiguous()``, so no value changes)
        out = {"W": W_local.contiguous(),
               "Z": rt.broadcast(Z_new, "z columns"),
               "Q": rt.broadcast(Q_new, "q columns"), "sv": svc}
        if metrics:
            # the grad slot reports the primal residual W - Z (the
            # gathered W_full is master-visible; the local W is sharded)
            out["obs"] = obs_round(Z, Z_new, grad=W_full - Z_new,
                                   objective=lam * nn,
                                   sv_stats=sv.device_stats(svc))
        return out

    W0 = torch.zeros((p, m), dtype=prob.Xs.dtype, device=prob.device)
    state = {"W": W0, "Z": W0, "Q": W0, "sv": _sv_carry0(sv, sv_carry)}
    if mc is not None:
        state["obs"] = mc[0]
    res = MTLResult("admm", state["W"], rt.comm,
                    extras={"lam": lam, "rho": rho, "sv_engine": sv.mode})
    stamp_sgd(res, sgd)
    res.record(0, state["W"])
    # the consensus variable Z is the estimator
    state = rt.run_rounds(rounds, body, state, sharded=("W",), scan=scan,
                          record=compose_records(iterate_recorder(
                              res, record_every, key="Z"), mc),
                          data_leaves=_round_leaves(prob, sgd))
    res.W = state["Z"]
    return _finish(res, sv, state, keep_sv_carry, rt, mc)


@register("dfw")
def dfw(prob: MTLProblem, radius: float = None, rounds: int = 200,
        record_every: int = 1, sv_iters: int = 60, runtime=None,
        scan: bool = True, metrics: bool = False, **_) -> MTLResult:
    """Appendix B: Frank-Wolfe over {||W||_* <= R}; the master only needs
    the leading singular pair of the gradient (:func:`leading_sv`, with
    ``sv_iters`` as its worst-case budget)."""
    rt = default_runtime(prob, runtime)
    if radius is None:
        radius = prob.nuclear_radius
    mc = metrics_channel(metrics, prob)

    def body(k, state, data):
        W = state["W"]
        G = _grad_columns(rt, prob, W, data, "gradient column")
        u, _, v = leading_sv(G, iters=sv_iters)
        gamma = 2.0 / (k + 2.0)
        # w_j <- (1-gamma) w_j - gamma R v_j u  (B.1)
        W_new = (1.0 - gamma) * W - gamma * radius * torch.outer(u, v)
        out = {"W": rt.broadcast(W_new, "v_j * u direction")}
        if metrics:
            # constraint form: no regularizer term, no shrink engine
            out["obs"] = obs_round(W, W_new, grad=G)
        return out

    state = {"W": torch.zeros((prob.p, prob.m), dtype=prob.Xs.dtype,
                              device=prob.device)}
    if mc is not None:
        state["obs"] = mc[0]
    res = MTLResult("dfw", state["W"], rt.comm, extras={"radius": radius})
    res.record(0, state["W"])
    state = rt.run_rounds(rounds, body, state, scan=scan,
                          record=compose_records(
                              iterate_recorder(res, record_every), mc),
                          data_leaves=gram_round_leaves(prob))
    res.W = state["W"]
    if mc is not None:
        res.extras["metrics"] = mc[2].finalize(rt)
    return res
