"""The paper's novel algorithms: greedy subspace pursuit (Section 4).

Port of ``repro.core.methods.greedy`` (the full-batch DGSP and DNSP).

DGSP (Algorithm 1): round t
  workers: send gradient column grad L_nj(w_j)           [1 vector of dim p]
  master:  (u, v) = SV(grad L_n(W)); broadcast u          [1 vector of dim p]
  workers: U <- [U u]; v_j = argmin_v L_nj(U v); w_j = U v_j

DNSP (Algorithm 6): same, but workers send NEWTON directions
  (hess L_nj)^-1 grad L_nj and the received u is Gram-Schmidt-orthogonalized
  against U before the projected re-fit.

The basis is kept at the fixed width ``rounds`` with a column-validity
mask, as in the reference (columns beyond the current round are zero
and contribute nothing to the projected design X U).  AltMin waits for
the draw-for-draw threefry port: its start ``U0`` comes from
``jax.random``.
"""
from __future__ import annotations

import torch

from .. import worker_ops
from ..spectral import leading_sv
from ..svd_ops import gram_schmidt_append
from .base import (MTLProblem, MTLResult, default_runtime, full_batch_only,
                   gram_round_leaves, iterate_recorder, register)


def _subspace_pursuit(prob: MTLProblem, rounds: int, direction: str,
                      record_every: int, sv_iters: int, l2: float,
                      newton_damping: float = 1e-6, runtime=None,
                      scan: bool = True, batch_size: int = None,
                      local_steps: int = None, metrics: bool = False
                      ) -> MTLResult:
    rt = default_runtime(prob, runtime)
    full_batch_only(prob, rt, batch_size, local_steps, metrics)
    m, p = prob.m, prob.p
    loss = prob.loss
    max_k = rounds
    name = "dgsp" if direction == "gradient" else "dnsp"

    def messages(W_local, data):
        if direction == "newton":
            return worker_ops.newton_columns(loss, W_local, data, prob.l2,
                                             newton_damping, rt=rt)
        return worker_ops.grad_columns(loss, W_local, data, prob.l2,
                                       rt=rt) / m

    def body(k, state, data):
        U, mask, W_local = state["U"], state["mask"], state["W"]
        G_local = messages(W_local, data)
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
        W_local, _ = worker_ops.projected_solves(loss, Um, data, l2, rt=rt)
        return {"U": U, "mask": mask, "W": W_local}

    dt, dev = prob.Xs.dtype, prob.device
    state = {"U": torch.zeros((p, max_k), dtype=dt, device=dev),
             "mask": torch.zeros((max_k,), dtype=dt, device=dev),
             "W": torch.zeros((p, m), dtype=dt, device=dev)}
    res = MTLResult(name, state["W"], rt.comm)
    res.record(0, state["W"])
    state = rt.run_rounds(rounds, body, state, sharded=("W",), scan=scan,
                          record=iterate_recorder(res, record_every),
                          data_leaves=gram_round_leaves(prob))
    res.W = state["W"]
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
                             metrics=metrics)


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
                             local_steps=local_steps, metrics=metrics)


@register("altmin")
def altmin(prob: MTLProblem, **_) -> MTLResult:
    """Not ported yet: its start ``U0`` is a ``jax.random.normal`` draw."""
    raise NotImplementedError(
        "altmin draws its start U0 from jax.random; it comes with the "
        "draw-for-draw threefry port, ROADMAP Queue 1 item 3")
