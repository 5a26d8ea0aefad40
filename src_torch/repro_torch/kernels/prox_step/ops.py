"""Dispatch for the fused prox step: the kernel on the card, the plain
version on the CPU.

Where the tensors lie decides, and nothing else: CUDA tensors always go
to the hand-written kernel (or raise), CPU tensors always go to
:func:`~.ref.prox_step_ref`.  There is no switch between the two and no
fallback.  ``prox_step.launches`` counts kernel launches, so a run can
show that its local steps went through the kernel.
"""
from __future__ import annotations

import torch

from . import kernel
from .ref import LOSSES, prox_step_ref


def _check(X, y, W, Z, Q, loss) -> torch.device:
    """Validate what the kernel takes; return the one device."""
    named = (("X", X), ("y", y), ("W", W), ("Z", Z), ("Q", Q))
    for name, t in named:
        if not isinstance(t, torch.Tensor):
            raise TypeError(f"{name} must be a torch.Tensor, got "
                            f"{type(t).__name__}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    devs = {t.device for _, t in named}
    if len(devs) != 1:
        raise ValueError(f"X, y, W, Z, Q lie on different devices: "
                         f"{sorted(map(str, devs))}")
    if X.ndim != 3 or y.ndim != 2 or any(t.ndim != 2 for t in (W, Z, Q)):
        raise ValueError(f"want X (L, n, p), y (L, n), W/Z/Q (L, p); got "
                         f"{[tuple(t.shape) for _, t in named]}")
    L, n, p = X.shape
    if tuple(y.shape) != (L, n) or any(tuple(t.shape) != (L, p)
                                       for t in (W, Z, Q)):
        raise ValueError(f"shape mismatch: {[tuple(t.shape) for _, t in named]}")
    if n < 1 or p < 1:
        raise ValueError(f"need at least one row and one feature, got "
                         f"n={n}, p={p}")
    if X.dtype not in kernel.X_DTYPES:
        raise TypeError(f"X must be float32 or bfloat16, got {X.dtype}")
    if any(t.dtype != torch.float32 for t in (y, W, Z, Q)):
        raise TypeError(f"y, W, Z and Q must be float32, got "
                        f"{[t.dtype for t in (y, W, Z, Q)]}")
    if loss not in LOSSES:
        raise ValueError(f"unknown loss {loss!r}; have {LOSSES}")
    return devs.pop()


def prox_step(X: torch.Tensor, y: torch.Tensor, W: torch.Tensor,
              Z: torch.Tensor, Q: torch.Tensor, *, eta, rho, inv_m, l2,
              loss: str = "squared") -> torch.Tensor:
    """One fused prox-family worker update over L task rows:
    X (L, n, p) f32/bf16; y (L, n), W/Z/Q (L, p) f32 -> (L, p) f32 with

        g_j = (1/n) X_jᵀ l'(X_j w_j, y_j) + l2 w_j
        w_j <- w_j - eta (g_j inv_m + q_j + rho (w_j - z_j))

    ``n`` is the rows this call sees (a mini-batch).  The four scalars
    are Python numbers, passed to the kernel as arguments.  On the card
    p is at most ``kernel.MAX_P``.
    """
    dev = _check(X, y, W, Z, Q, loss)
    scalars = tuple(float(v) for v in (eta, rho, inv_m, l2))
    if dev.type == "cpu":
        return prox_step_ref(X, y, W, Z, Q, *scalars, loss=loss)
    if dev.type != "cuda":
        raise ValueError(f"prox_step runs on the CPU or a CUDA device, "
                         f"not {dev}")
    L, _, p = X.shape
    if p > kernel.MAX_P:
        raise ValueError(f"p={p} exceeds the kernel's {kernel.MAX_P}")
    if L == 0:
        return torch.empty((0, p), dtype=torch.float32, device=dev)
    out = kernel.launch(X, y, W, Z, Q, *scalars, loss)
    prox_step.launches += 1
    return out


prox_step.launches = 0
