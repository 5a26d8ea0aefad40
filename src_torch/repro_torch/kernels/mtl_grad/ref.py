"""Plain PyTorch per-task gradients.

Port of ``repro.kernels.mtl_grad.ref``: the reference oracle's two
einsums.  :func:`task_gradients_ref` is the CPU path of
:func:`repro_torch.kernels.mtl_grad.ops.task_gradients` and the oracle
the CUDA kernel is held against on the card.
"""
from __future__ import annotations

import torch

LOSSES = ("squared", "logistic")


def task_gradients_ref(X: torch.Tensor, y: torch.Tensor, W: torch.Tensor, *,
                       loss: str = "squared") -> torch.Tensor:
    """X (m, n, p) f32/bf16; y (m, n); W (m, p) -> G (m, p) f32 with
    ``G[j] = (1/n) X_jᵀ l'(X_j w_j, y_j)``."""
    Xf = X.to(torch.float32)
    yf = y.to(torch.float32)
    Wf = W.to(torch.float32)
    pred = torch.einsum("mnp,mp->mn", Xf, Wf)
    if loss == "squared":
        r = pred - yf
    elif loss == "logistic":
        r = -yf * torch.sigmoid(-yf * pred)
    else:
        raise ValueError(f"unknown loss {loss!r}; have {LOSSES}")
    return torch.einsum("mnp,mn->mp", Xf, r) / X.shape[1]
