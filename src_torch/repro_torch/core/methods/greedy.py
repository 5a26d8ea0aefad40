"""The paper's novel algorithms: greedy subspace pursuit (Section 4).

Port of ``repro.core.methods.greedy``.

DGSP (Algorithm 1): round t
  workers: send gradient column grad L_nj(w_j)           [1 vector of dim p]
  master:  (u, v) = SV(grad L_n(W)); broadcast u          [1 vector of dim p]
  workers: U <- [U u]; v_j = argmin_v L_nj(U v); w_j = U v_j

DNSP (Algorithm 6): same, but workers send NEWTON directions
  (hess L_nj)^-1 grad L_nj and the received u is Gram-Schmidt-orthogonalized
  against U before the projected re-fit.

AltMin (Appendix H comparison): alternating minimization over W = U V^T.

The basis is kept at the fixed width ``rounds`` with a column-validity
mask, as in the reference (columns beyond the current round are zero
and contribute nothing to the projected design X U).  DGSP and DNSP
also take the stochastic worker path (``batch_size``/``local_steps``):
local step 0 draws the round's message batch, steps 1..L the projected
SGD refit of the codes ``V``, which are worker state like ``W``.
"""
from __future__ import annotations

import torch

from .. import prng, worker_ops
from ..spectral import leading_sv
from ..svd_ops import gram_schmidt_append
from ...obs.device import obs_round
from .base import (MTLProblem, MTLResult, compose_records, default_runtime,
                   gram_round_leaves, iterate_recorder, metrics_channel,
                   register, stamp_sgd, stochastic_config,
                   stochastic_round_leaves)


def _subspace_pursuit(prob: MTLProblem, rounds: int, direction: str,
                      record_every: int, sv_iters: int, l2: float,
                      newton_damping: float = 1e-6, runtime=None,
                      scan: bool = True, batch_size: int = None,
                      local_steps: int = None, batch_seed: int = 0,
                      metrics: bool = False) -> MTLResult:
    rt = default_runtime(prob, runtime)
    m, p = prob.m, prob.p
    loss = prob.loss
    max_k = rounds
    name = "dgsp" if direction == "gradient" else "dnsp"
    sgd = stochastic_config(prob, batch_size, local_steps, rt.data_shards)
    mc = metrics_channel(metrics, prob)

    def messages(W_local, data, k):
        if sgd is not None:
            # local step 0 is the round's message batch; the refit's
            # projected SGD steps fold steps 1..L, so every draw in a
            # round is distinct
            if direction == "newton":
                return worker_ops.minibatch_newton_columns(
                    loss, W_local, data, prob.l2, newton_damping, rt=rt,
                    seed=batch_seed, round_k=k, local_step=0,
                    batch_size=sgd[0])
            return worker_ops.minibatch_grad_columns(
                loss, W_local, data, prob.l2, rt=rt, seed=batch_seed,
                round_k=k, local_step=0, batch_size=sgd[0]) / m
        if direction == "newton":
            return worker_ops.newton_columns(loss, W_local, data, prob.l2,
                                             newton_damping, rt=rt)
        return worker_ops.grad_columns(loss, W_local, data, prob.l2,
                                       rt=rt) / m

    if sgd is not None:
        # with orthonormal columns of U the projected per-task Gram
        # U^T A_j U inherits the data spectral bound, so the full-batch
        # step is safe for the projected SGD on the codes
        from .convex import data_smoothness
        eta_v = 1.0 / data_smoothness(prob)

    def refit(Um, V, data, k):
        """v_j = argmin_v L_nj(U v): the exact projected ERM in the
        full-batch path; ``local_steps`` seeded projected SGD steps on
        the codes (communication-free) in the stochastic path."""
        if sgd is None:
            W_local, _ = worker_ops.projected_solves(loss, Um, data, l2,
                                                     rt=rt)
            return W_local, V
        B, L = sgd
        for i in range(L):
            g = worker_ops.minibatch_grad_columns(
                loss, Um @ V, data, max(l2, 1e-9), rt=rt, seed=batch_seed,
                round_k=k, local_step=i + 1, batch_size=B)
            V = V - eta_v * (Um.T @ g)
        return Um @ V, V

    def body(k, state, data):
        U, mask, W_local = state["U"], state["mask"], state["W"]
        G_local = messages(W_local, data, k)
        G = rt.gather_columns(
            G_local, "gradient" if direction == "gradient" else "newton dir")
        u, _, _ = leading_sv(G, iters=sv_iters)        # master
        if direction == "newton":
            u = gram_schmidt_append(U, u, mask)        # Alg 6 lines 7-9
        u = rt.broadcast(u, "new basis vector u")
        U = U.clone()                                  # workers append
        U[:, k] = u
        mask = mask.clone()
        mask[k] = 1.0
        Um = U * mask[None, :]
        W_local, V = refit(Um, state.get("V"), data, k)
        out = {"U": U, "mask": mask, "W": W_local}
        if sgd is not None:
            out["V"] = V
        if metrics:
            # W is worker-sharded here; the replicated master quantities
            # are the gathered message matrix and the masked basis, so
            # step_norm reports the appended column's growth
            out["obs"] = obs_round(state["U"] * state["mask"][None, :],
                                   Um, grad=G)
        return out

    dt, dev = prob.Xs.dtype, prob.device
    state = {"U": torch.zeros((p, max_k), dtype=dt, device=dev),
             "mask": torch.zeros((max_k,), dtype=dt, device=dev),
             "W": torch.zeros((p, m), dtype=dt, device=dev)}
    sharded = ("W",)
    if sgd is not None:
        # the codes are worker state like W: (max_k, m) task columns
        state["V"] = torch.zeros((max_k, m), dtype=dt, device=dev)
        sharded = ("W", "V")
    if mc is not None:
        state["obs"] = mc[0]
    res = MTLResult(name, state["W"], rt.comm)
    stamp_sgd(res, sgd)
    res.record(0, state["W"])
    state = rt.run_rounds(rounds, body, state, sharded=sharded, scan=scan,
                          record=compose_records(
                              iterate_recorder(res, record_every), mc),
                          data_leaves=gram_round_leaves(prob) if sgd is None
                          else stochastic_round_leaves(prob))
    res.W = state["W"]
    if mc is not None:
        res.extras["metrics"] = mc[2].finalize(rt)
    res.extras["U"] = state["U"]
    res.extras["mask"] = state["mask"]
    return res


@register("dgsp")
def dgsp(prob: MTLProblem, rounds: int = 20, record_every: int = 1,
         sv_iters: int = 60, l2: float = 0.0, runtime=None,
         scan: bool = True, batch_size: int = None, local_steps: int = None,
         batch_seed: int = 0, metrics: bool = False, **_) -> MTLResult:
    return _subspace_pursuit(prob, rounds, "gradient", record_every,
                             sv_iters, l2 if l2 else prob.l2,
                             runtime=runtime, scan=scan,
                             batch_size=batch_size, local_steps=local_steps,
                             batch_seed=batch_seed, metrics=metrics)


@register("dnsp")
def dnsp(prob: MTLProblem, rounds: int = 20, record_every: int = 1,
         sv_iters: int = 60, l2: float = 0.0, damping: float = 1e-4,
         runtime=None, scan: bool = True, batch_size: int = None,
         local_steps: int = None, batch_seed: int = 0,
         metrics: bool = False, **_) -> MTLResult:
    return _subspace_pursuit(prob, rounds, "newton", record_every,
                             sv_iters, l2 if l2 else prob.l2,
                             newton_damping=damping, runtime=runtime,
                             scan=scan, batch_size=batch_size,
                             local_steps=local_steps, batch_seed=batch_seed,
                             metrics=metrics)


@register("altmin")
def altmin(prob: MTLProblem, rank: int = None, rounds: int = 30,
           record_every: int = 1, l2: float = 1e-6, u_grad_steps: int = 20,
           runtime=None, scan: bool = True, metrics: bool = False,
           **_) -> MTLResult:
    """Alternating minimization over W = U V^T (Jain et al.; App-H baseline).

    The V-step is an exact per-task projected ERM (local).  The U-step
    minimizes the global objective over U given V: for the squared loss
    a p*r linear system assembled from per-task moments (one sum_tasks
    collective); for the logistic loss ``u_grad_steps`` gradient steps
    on U, each a gather of per-task gradient columns (the ``mtl_grad``
    kernel on the card).  ``U0`` is the reference's: the Q factor of a
    ``jax.random.normal(PRNGKey(0), (p, r))`` draw, through
    :mod:`repro_torch.core.prng`.
    """
    rt = default_runtime(prob, runtime)
    m, p = prob.m, prob.p
    r = int(rank if rank is not None else prob.r)
    loss = prob.loss
    key = prng.PRNGKey(0, device=prob.device)
    U0 = torch.linalg.qr(prng.normal(key, (p, r), prob.Xs.dtype))[0]

    def v_of(U, data):
        _, V = worker_ops.projected_solves(loss, U, data, max(l2, 1e-9),
                                           rt=rt)
        return V                                        # (r, L)

    def moments(G, g, v):
        # kron(outer(v, v), G) and kron(v, g), written out
        A = torch.einsum("ab,ik->aibk", torch.outer(v, v), G)
        A = A.reshape(p * r, p * r)
        return A, torch.einsum("a,i->ai", v, g).reshape(p * r)

    def body(k, state, data):
        U = state["U"]
        V = v_of(U, data)
        if loss.name == "squared":
            # min_U (1/2nm) sum_j ||X_j U v_j - y_j||^2: vec(U) solve from
            # per-task moments, summed on the master
            if worker_ops.has_gram(data):
                G_all, g_all = data["gram_A"], data["gram_b"]
            else:
                def stats(X, y):
                    return X.T @ X / prob.n, X.T @ y / prob.n
                G_all, g_all = rt.worker_map(stats, in_axes=(0, 0))(
                    data["Xs"], data["ys"])
                G_all = rt.psum_data(G_all, "per-task gram shards")
                g_all = rt.psum_data(g_all, "per-task Xty shards")
            A_all, b_all = rt.worker_map(moments, in_axes=(0, 0, 1))(
                G_all, g_all, V)
            Amat = rt.sum_tasks(A_all, "per-task moment matrices") / m \
                + l2 * torch.eye(p * r, dtype=U.dtype, device=U.device)
            b = rt.sum_tasks(b_all, "per-task moment vectors") / m
            vecU = torch.linalg.solve(Amat, b)
            U_new = vecU.reshape(r, p).T
        else:
            # logistic: gradient steps on U; each step gathers the fresh
            # per-task gradient columns (an honest round of collectives)
            V_full = rt.gather_columns(V, "v coefficients")
            U_new = U
            for _ in range(u_grad_steps):
                G_loc = worker_ops.grad_columns(loss, U_new @ V, data,
                                                prob.l2, rt=rt)
                G = rt.gather_columns(G_loc, "gradient columns")
                U_new = U_new - (G @ V_full.T) / m
        U_new = rt.broadcast(U_new, "updated U", vectors=r, dim=p)
        V2 = v_of(U_new, data)
        out = {"U": U_new, "W": U_new @ V2}
        if metrics:
            # W is worker-sharded; the replicated factor U is the
            # master-visible iterate
            out["obs"] = obs_round(U, U_new)
        return out

    mc = metrics_channel(metrics, prob)
    state = {"U": U0, "W": torch.zeros((p, m), dtype=prob.Xs.dtype,
                                       device=prob.device)}
    if mc is not None:
        state["obs"] = mc[0]
    res = MTLResult("altmin", state["W"], rt.comm)
    res.record(0, state["W"])
    state = rt.run_rounds(rounds, body, state, sharded=("W",), scan=scan,
                          record=compose_records(
                              iterate_recorder(res, record_every), mc),
                          data_leaves=gram_round_leaves(prob))
    res.W = state["W"]
    res.extras["U"] = state["U"]
    if mc is not None:
        res.extras["metrics"] = mc[2].finalize(rt)
    return res
