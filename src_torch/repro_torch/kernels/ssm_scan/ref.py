"""Plain PyTorch selective scan with an optional carried state.

The oracle of the reference's kernel (``repro.kernels.ssm_scan.ref``),
plus ``h0``: the direct recurrence in float32, one step at a time,

    h_t = exp(dt_t * A) * h_{t-1} + (dt_t * x_t) B_t^T,   y_t = h_t C_t,

carrying only the (B, I, N) state.  It never builds a (B, S, I, N)
tensor: at the served prefill shape (8, 2048, 8192, 16) that would be
8.6 GB, and the reference's non-kernel branches build two.

:func:`mamba_scan_ref` is the Mamba-1 mixer's chain around that scan,
the torch ops ``models/ssm.py`` ran before the kernel took them in: the
softplus of dt, ``A = -exp(A_log)``, the D skip and the SiLU gate, with
their dtype promotions and roundings.

Each is the CPU path of its entry in
:mod:`repro_torch.kernels.ssm_scan.ops` and the oracle the CUDA kernel is
held against on the card.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F


def selective_scan_ref(x: torch.Tensor, dt: torch.Tensor, Bc: torch.Tensor,
                       Cc: torch.Tensor, A: torch.Tensor,
                       h0: Optional[torch.Tensor] = None
                       ) -> Tuple[torch.Tensor, torch.Tensor]:
    """x, dt (B, S, I); Bc, Cc (B, S, N); A (I, N); h0 (B, I, N) or None
    (zeros) -> (y (B, S, I) f32, h_final (B, I, N) f32).  ``h0`` is not
    written."""
    f32 = torch.float32
    B, S, I = x.shape
    N = Bc.shape[-1]
    A = A.to(f32)
    h = (torch.zeros((B, I, N), dtype=f32, device=x.device) if h0 is None
         else h0.to(f32))
    y = torch.empty((B, S, I), dtype=f32, device=x.device)
    for t in range(S):
        dtt = dt[:, t].to(f32)                                   # (B, I)
        bu = (dtt * x[:, t].to(f32))[:, :, None] \
            * Bc[:, t].to(f32)[:, None, :]                       # (B, I, N)
        h = torch.exp(dtt[:, :, None] * A) * h + bu
        y[:, t] = torch.bmm(h, Cc[:, t].to(f32)[:, :, None])[..., 0]
    return y, h


def mamba_scan_ref(x: torch.Tensor, dt_lin: torch.Tensor,
                   dt_bias: torch.Tensor, Bc: torch.Tensor, Cc: torch.Tensor,
                   A_log: torch.Tensor, D: torch.Tensor, z: torch.Tensor,
                   h0: Optional[torch.Tensor] = None
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """x, dt_lin, z (B, S, I) in the model's dtype; dt_bias, D (I,) and
    A_log (I, N) float32; Bc, Cc (B, S, N); h0 (B, I, N) or None ->
    (out (B, S, I) in x's dtype, h_final (B, I, N) f32), with

        dt  = softplus(dt_lin + dt_bias)       (model dtype + f32 -> f32)
        y   = scan(x, dt, Bc, Cc, -exp(A_log), h0)
        out = (y + D x).to(x.dtype) * silu(z)

    ``h0`` is not written."""
    dt = F.softplus(dt_lin + dt_bias).to(torch.float32)
    y, h = selective_scan_ref(x, dt, Bc, Cc, -torch.exp(A_log), h0)
    y = y + D * x.to(torch.float32)
    return y.to(x.dtype) * F.silu(z), h
