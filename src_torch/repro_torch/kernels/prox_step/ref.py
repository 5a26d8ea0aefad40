"""Plain PyTorch fused prox-family worker step.

Port of ``repro.kernels.prox_step.ref``: two einsums around the loss
derivative, then the step, in the kernel's order.  :func:`prox_step_ref`
is the CPU path of :func:`repro_torch.kernels.prox_step.ops.prox_step`
and the oracle the CUDA kernel is held against on the card.
"""
from __future__ import annotations

import torch

LOSSES = ("squared", "logistic")


def prox_step_ref(X: torch.Tensor, y: torch.Tensor, W: torch.Tensor,
                  Z: torch.Tensor, Q: torch.Tensor, eta, rho, inv_m, l2,
                  loss: str = "squared") -> torch.Tensor:
    """X (L, n, p) f32/bf16; y (L, n); W/Z/Q (L, p) -> the stepped W
    (L, p) f32: ``g = acc/n + l2·w`` with ``acc = Xᵀ l'(X w, y)``, then
    ``w - eta·(g·inv_m + q + rho·(w - z))``."""
    Xf = X.to(torch.float32)
    yf = y.to(torch.float32)
    Wf = W.to(torch.float32)
    pred = torch.einsum("lnp,lp->ln", Xf, Wf)
    if loss == "squared":
        r = pred - yf
    elif loss == "logistic":
        r = -yf * torch.sigmoid(-yf * pred)
    else:
        raise ValueError(f"unknown loss {loss!r}; have {LOSSES}")
    g = torch.einsum("lnp,ln->lp", Xf, r) / X.shape[1] + l2 * Wf
    step = g * inv_m + Q.to(torch.float32) + rho * (Wf - Z.to(torch.float32))
    return Wf - eta * step
