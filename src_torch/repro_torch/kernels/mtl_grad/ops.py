"""Dispatch for the per-task gradients: the kernel on the card, the plain
version on the CPU.

Where the tensors lie decides, and nothing else: CUDA tensors always go
to the hand-written kernel (or raise), CPU tensors always go to
:func:`~.ref.task_gradients_ref`.  There is no switch between the two and
no fallback.  ``task_gradients.launches`` counts kernel launches, so a
run can show that its gradients went through the kernel.
"""
from __future__ import annotations

import torch

from . import kernel
from .ref import LOSSES, task_gradients_ref


def _check(X, y, W, loss) -> torch.device:
    """Validate what the kernel takes; return the one device."""
    for name, t in (("X", X), ("y", y), ("W", W)):
        if not isinstance(t, torch.Tensor):
            raise TypeError(f"{name} must be a torch.Tensor, got {type(t).__name__}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    devs = {t.device for t in (X, y, W)}
    if len(devs) != 1:
        raise ValueError(f"X, y, W lie on different devices: "
                         f"{sorted(map(str, devs))}")
    if X.ndim != 3 or y.ndim != 2 or W.ndim != 2:
        raise ValueError(f"want X (m, n, p), y (m, n), W (m, p); got "
                         f"{tuple(X.shape)}, {tuple(y.shape)}, {tuple(W.shape)}")
    m, n, p = X.shape
    if tuple(y.shape) != (m, n) or tuple(W.shape) != (m, p):
        raise ValueError(f"shape mismatch: X {tuple(X.shape)}, y "
                         f"{tuple(y.shape)}, W {tuple(W.shape)}")
    if n < 1 or p < 1:
        raise ValueError(f"need at least one row and one feature, got "
                         f"n={n}, p={p}")
    if X.dtype not in kernel.X_DTYPES:
        raise TypeError(f"X must be float32 or bfloat16, got {X.dtype}")
    if y.dtype != torch.float32 or W.dtype != torch.float32:
        raise TypeError(f"y and W must be float32, got {y.dtype} and {W.dtype}")
    if loss not in LOSSES:
        raise ValueError(f"unknown loss {loss!r}; have {LOSSES}")
    return devs.pop()


def task_gradients(X: torch.Tensor, y: torch.Tensor, W: torch.Tensor, *,
                   loss: str = "squared") -> torch.Tensor:
    """Per-task gradients: X (m, n, p) f32/bf16; y (m, n) f32; W (m, p)
    f32 -> G (m, p) f32 with ``G[j] = (1/n) X_jᵀ l'(X_j w_j, y_j)``.

    The output is divided by the rows this call sees (the reference's
    convention, so per-shard outputs of a data-sharded task can be
    averaged).  On the card p is at most ``kernel.MAX_P``.
    """
    dev = _check(X, y, W, loss)
    if dev.type == "cpu":
        return task_gradients_ref(X, y, W, loss=loss)
    if dev.type != "cuda":
        raise ValueError(f"task_gradients runs on the CPU or a CUDA device, "
                         f"not {dev}")
    m, _, p = X.shape
    if p > kernel.MAX_P:
        raise ValueError(f"p={p} exceeds the kernel's {kernel.MAX_P}")
    if m == 0:
        return torch.empty((0, p), dtype=torch.float32, device=dev)
    G = kernel.launch(X, y, W, loss)
    task_gradients.launches += 1
    return G


task_gradients.launches = 0
