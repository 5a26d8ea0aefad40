"""Recompute-in-backward: the port's ``jax.checkpoint``.

:func:`recompute_vjp` runs a function without recording a graph and, in
backward, re-runs a differentiable function of the same inputs with
gradients on and returns its vector-Jacobian product.  Two uses:

* per-layer rematerialization (``cfg.remat``) and the chunked scan's
  per-chunk rematerialization: the same function both ways;
* the LM kernels: the hand-written kernel (which autograd cannot see
  through) forward, a differentiable twin of the reference's XLA route
  backward.

It is a plain ``torch.autograd.Function``: ``torch.utils.checkpoint``
would import ``torch._dynamo``, which writes ``os.environ``.
"""
from __future__ import annotations

from typing import Callable, Sequence

import torch


class _Recompute(torch.autograd.Function):
    """``forward(run, twin, n_inputs, *inputs, *leaves)``: ``run(*inputs)``
    with no graph; backward differentiates ``twin(*inputs)`` with
    respect to the inputs and the leaves (tensors ``twin`` reads that
    are not arguments, such as a layer's parameters)."""

    @staticmethod
    def forward(ctx, run, twin, n_inputs, *args):
        ctx.twin, ctx.n_inputs = twin, n_inputs
        ctx.leaves = args[n_inputs:]
        ctx.save_for_backward(*args[:n_inputs])
        ctx.set_materialize_grads(False)
        return run(*args[:n_inputs])

    @staticmethod
    def backward(ctx, *grads):
        need = ctx.needs_input_grad[3:]
        inputs = [t.detach().requires_grad_(n)
                  for t, n in zip(ctx.saved_tensors, need)]
        with torch.enable_grad():
            out = ctx.twin(*inputs)
        outs = out if isinstance(out, tuple) else (out,)
        pairs = [(o, g) for o, g in zip(outs, grads)
                 if g is not None and o.requires_grad]
        wrt = [t for t, n in zip((*inputs, *ctx.leaves), need) if n]
        got = iter(torch.autograd.grad([o for o, _ in pairs], wrt,
                                       [g for _, g in pairs],
                                       allow_unused=True)
                   if pairs else [None] * len(wrt))
        return (None, None, None, *(next(got) if n else None for n in need))


def recompute_vjp(run: Callable, twin: Callable,
                  inputs: Sequence[torch.Tensor],
                  leaves: Sequence[torch.Tensor] = ()):
    """``run(*inputs)``, whose gradient is that of ``twin(*inputs)``,
    recomputed in backward.  ``twin`` must compute the same function
    (or, for a kernel, the reference's route to it) and return the same
    structure (a tensor or a tuple of tensors); ``leaves`` are the
    tensors it reads besides its arguments that want gradients."""
    return _Recompute.apply(run, twin, len(inputs), *inputs, *leaves)
