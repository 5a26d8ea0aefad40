"""Shared model components: norms, embeddings, RoPE, initializers.

Port of ``repro.models.common``.  Weights keep the reference's layouts
(dense weights ``(d_in, d_out)``, applied as ``x @ w``; the embedding
table ``(vocab, d_model)``), so a reference parameter tree crosses over
as a copy and a rename (:func:`repro_torch.interop.lm_params_from_numpy`).
Initializers draw from an explicit ``torch.Generator`` on the target
device with the reference's standard deviations; the draws themselves
differ from ``jax.random``'s, and parity tests convert the reference's
parameters instead.
"""
from __future__ import annotations

import math
from typing import Optional

import torch
from torch import nn

from ..configs.base import ModelConfig


def dtype_of(cfg: ModelConfig) -> torch.dtype:
    return {"float32": torch.float32, "bfloat16": torch.bfloat16}[cfg.dtype]


def truncated_normal_(t: torch.Tensor, std: float,
                      generator: Optional[torch.Generator]) -> torch.Tensor:
    """Fill ``t`` with a normal of ``std`` truncated at ±2σ, as the
    reference's ``truncated_normal``: drawn in float32, cast once to
    ``t``'s dtype."""
    f = torch.empty(t.shape, dtype=torch.float32, device=t.device)
    nn.init.trunc_normal_(f, 0.0, std, -2.0 * std, 2.0 * std,
                          generator=generator)
    with torch.no_grad():
        t.copy_(f)
    return t


def dense_param(d_in: int, d_out: int, dtype: torch.dtype,
                device: torch.device) -> nn.Parameter:
    """An uninitialised ``(d_in, d_out)`` weight; ``init_dense`` fills it."""
    return nn.Parameter(torch.empty((d_in, d_out), dtype=dtype,
                                    device=device), requires_grad=False)


def init_dense(w: torch.Tensor, generator: Optional[torch.Generator],
               std: Optional[float] = None) -> torch.Tensor:
    """The reference's ``init_dense``: std ``d_in ** -0.5`` unless given."""
    return truncated_normal_(w, std if std is not None
                             else w.shape[0] ** -0.5, generator)


# --- norms -------------------------------------------------------------------

class Norm(nn.Module):
    """RMSNorm or LayerNorm in float32 with the ``(1 + scale)``
    parameterisation (zero scale is the identity), cast back to the
    input's dtype.  ``scale`` (and LayerNorm's ``bias``) stay float32."""

    def __init__(self, cfg: ModelConfig, d: int, device: torch.device):
        super().__init__()
        self.kind, self.eps = cfg.norm, cfg.norm_eps
        z = lambda: nn.Parameter(torch.zeros(d, dtype=torch.float32,
                                             device=device),
                                 requires_grad=False)
        self.scale = z()
        self.bias = z() if cfg.norm != "rmsnorm" else None

    def reset_parameters(self) -> None:
        with torch.no_grad():
            self.scale.zero_()
            if self.bias is not None:
                self.bias.zero_()

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        xf = x.to(torch.float32)
        if self.kind == "rmsnorm":
            var = (xf * xf).mean(-1, keepdim=True)
            out = xf * torch.rsqrt(var + self.eps) * (1.0 + self.scale)
        else:
            mu = xf.mean(-1, keepdim=True)
            var = xf.var(-1, keepdim=True, unbiased=False)
            out = ((xf - mu) * torch.rsqrt(var + self.eps)
                   * (1.0 + self.scale) + self.bias)
        return out.to(x.dtype)


# --- embeddings ------------------------------------------------------------

def embed(table: torch.Tensor, tokens: torch.Tensor,
          cfg: ModelConfig) -> torch.Tensor:
    """Rows of ``table``; gemma scales them by ``sqrt(d_model)`` rounded
    to the table's dtype, as the reference does."""
    x = table[tokens]
    if cfg.scale_embeddings:
        x = x * torch.tensor(math.sqrt(cfg.d_model),
                             dtype=torch.float32).to(x.dtype).item()
    return x


def unembed(table: torch.Tensor, head: Optional[torch.Tensor],
            x: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    """Project to the vocabulary with the tied table or the untied head
    ``(vocab, d_model)``, then the final softcap ``c·tanh(logits/c)``,
    in the activations' dtype."""
    w = table if cfg.tie_embeddings else head
    logits = x @ w.T
    if cfg.final_logit_softcap:
        c = cfg.final_logit_softcap
        logits = c * torch.tanh(logits / c)
    return logits


# --- RoPE ---------------------------------------------------------------------

def rope_freqs(head_dim: int, theta: float,
               device: torch.device) -> torch.Tensor:
    expo = -torch.arange(0, head_dim, 2, dtype=torch.float32,
                         device=device) / head_dim
    return torch.pow(torch.tensor(theta, dtype=torch.float32, device=device),
                     expo)


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float) -> torch.Tensor:
    """Rotary embedding over split halves (not interleaved), in float32,
    cast back.  x: (B, S, H, hd); positions: (B, S)."""
    freqs = rope_freqs(x.shape[-1], theta, x.device)              # (hd/2,)
    ang = positions[..., None].to(torch.float32) * freqs          # (B,S,hd/2)
    cos = torch.cos(ang)[..., None, :]                             # (B,S,1,hd/2)
    sin = torch.sin(ang)[..., None, :]
    x1, x2 = x.to(torch.float32).chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)
