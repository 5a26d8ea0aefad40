"""Dense MLPs: SwiGLU, GeGLU (gemma), plain GELU (starcoder2).

Port of ``repro.models.mlp``.  GELU is the tanh form, as the reference's
``jax.nn.gelu(approximate=True)``.  The three products are plain
matrix products (``x @ w``), which the reference also leaves to its
compiler rather than to a Pallas kernel.
"""
from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from ..configs.base import ModelConfig
from .common import dense_param, dtype_of, init_dense


def _act(name: str):
    return {"silu": F.silu,
            "gelu": lambda x: F.gelu(x, approximate="tanh")}[name]


class MLP(nn.Module):
    """``act(x @ w_gate) * (x @ w_up) @ w_down`` when ``cfg.glu``, else
    ``act(x @ w_up) @ w_down``."""

    def __init__(self, cfg: ModelConfig, device: torch.device):
        super().__init__()
        d_ff, dt = cfg.d_ff, dtype_of(cfg)
        self.act = _act(cfg.act)
        self.w_gate = (dense_param(cfg.d_model, d_ff, dt, device)
                       if cfg.glu else None)
        self.w_up = dense_param(cfg.d_model, d_ff, dt, device)
        self.w_down = dense_param(d_ff, cfg.d_model, dt, device)

    def reset_parameters(self, generator: Optional[torch.Generator]) -> None:
        if self.w_gate is not None:
            init_dense(self.w_gate, generator)
        init_dense(self.w_up, generator)
        init_dense(self.w_down, generator, std=self.w_down.shape[0] ** -0.5)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.w_gate is not None:
            h = self.act(x @ self.w_gate) * (x @ self.w_up)
        else:
            h = self.act(x @ self.w_up)
        return h @ self.w_down
