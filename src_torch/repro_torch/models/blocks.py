"""Layer-stack assembly: the segment plan, the attention layer, caches.

Port of the dense part of ``repro.models.blocks``.  The reference
compiles an architecture into a plan of segments and runs each segment's
stacked layers with ``lax.scan``; the port keeps the plan, unrolls it
into an ``nn.ModuleList`` of layers in the reference's order, and runs
them with a Python loop (no scan: ``cfg.scan_layers`` only shapes the
reference's compiled programs).  Training reads two more fields: under
``cfg.remat`` the training trunk rematerializes each layer in backward
(:func:`repro_torch.models.model.lm_loss`), and under
``cfg.bf16_grad_boundary`` the layers pass their inputs through
:func:`grad_cast`, as the reference's do.

Ported segments: ``"attn"`` (uniform attention layers),
``"attn_pattern"`` (super-blocks cycling ``cfg.attn_pattern``, gemma2's
local/global pairs, layers in pattern order within each super-block) and
``"mamba"`` (Mamba-1 layers, falcon-mamba).  The reference's
``"shared_attn"`` and ``"xattn"`` segments and MoE layers are not
ported: their families raise :class:`NotImplementedError` in
:mod:`repro_torch.models.model`.
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional

import torch
from torch import nn

from ..configs.base import ModelConfig
from .attention import Attention, init_kv_cache
from .common import Norm
from .mlp import MLP
from .ssm import Mamba1, init_ssm_state


@dataclasses.dataclass(frozen=True)
class Segment:
    kind: str
    count: int = 1
    window: Optional[int] = None


def build_plan(cfg: ModelConfig) -> List[Segment]:
    """The reference's segment plan for a dense or Mamba config (the
    families and MoE that it does not cover are refused by
    :func:`repro_torch.models.model._check_ported` first)."""
    if cfg.family == "ssm":
        return [Segment("mamba", cfg.n_layers)]
    if cfg.attn_pattern:
        plen = len(cfg.attn_pattern)
        if cfg.n_layers % plen:
            raise ValueError(f"{cfg.arch_id}: n_layers {cfg.n_layers} is not "
                             f"a multiple of the pattern length {plen}")
        return [Segment("attn_pattern", cfg.n_layers // plen)]
    return [Segment("attn", cfg.n_layers, window=cfg.sliding_window)]


def _pattern_names(cfg: ModelConfig) -> List[str]:
    """Names of a super-block's layers: the pattern entry, suffixed with
    its index where the entry repeats."""
    return [name if cfg.attn_pattern.count(name) == 1 else f"{name}{i}"
            for i, name in enumerate(cfg.attn_pattern)]


def segment_windows(cfg: ModelConfig, seg: Segment) -> List[Optional[int]]:
    """The sliding window of each layer of a segment, in layer order
    (None: global attention)."""
    if seg.kind == "attn":
        return [seg.window] * seg.count
    if seg.kind == "attn_pattern":
        per = [cfg.sliding_window if name.startswith("local") else None
               for name in _pattern_names(cfg)]
        return per * seg.count
    raise ValueError(seg.kind)


class _GradCast(torch.autograd.Function):
    """Identity forward; backward casts the cotangent to x's dtype."""

    @staticmethod
    def forward(ctx, x):
        ctx.dtype = x.dtype
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return g.to(ctx.dtype)


def grad_cast(x: torch.Tensor) -> torch.Tensor:
    """The reference's ``_grad_cast``: x, with its cotangent cast to x's
    dtype in backward (the reference keeps f32 activation gradients from
    doubling the bytes of its tensor-parallel all-reduces)."""
    return _GradCast.apply(x)


class AttnLayer(nn.Module):
    """Pre-norm attention + MLP residual layer (the reference's
    ``_attn_layer`` without MoE or cross-attention)."""

    def __init__(self, cfg: ModelConfig, window: Optional[int],
                 device: torch.device):
        super().__init__()
        self.window = window
        self.grad_boundary = cfg.bf16_grad_boundary
        self.norm1 = Norm(cfg, cfg.d_model, device)
        self.attn = Attention(cfg, device)
        self.norm2 = Norm(cfg, cfg.d_model, device)
        self.mlp = MLP(cfg, device)

    def reset_parameters(self, generator: Optional[torch.Generator]) -> None:
        self.norm1.reset_parameters()
        self.attn.reset_parameters(generator)
        self.norm2.reset_parameters()
        self.mlp.reset_parameters(generator)

    def forward(self, x: torch.Tensor, *, positions: torch.Tensor,
                cache: Optional[dict] = None) -> torch.Tensor:
        cast = self.grad_boundary and torch.is_grad_enabled()
        if cast:
            x = grad_cast(x)
        h = self.norm1(x)
        if cast:
            h = grad_cast(h)          # cotangent entering the qkv products
        x = x + self.attn(h, positions=positions, cache=cache,
                          window=self.window)
        h = self.norm2(x)
        if cast:
            h = grad_cast(h)          # cotangent entering the mlp products
        return x + self.mlp(h)


class MambaLayer(nn.Module):
    """Pre-norm Mamba-1 residual layer (the reference's ``_mamba_layer``).
    Positions are not read.
    With a cache ``{"state", "conv"}`` the scan and the conv continue
    from it, and both are written in place (the serving engine owns
    them, as it owns the attention layers' ring buffers): the state by
    the scan itself, the conv window by a copy."""

    def __init__(self, cfg: ModelConfig, device: torch.device):
        super().__init__()
        self.grad_boundary = cfg.bf16_grad_boundary
        self.norm1 = Norm(cfg, cfg.d_model, device)
        self.mamba = Mamba1(cfg, device)

    def reset_parameters(self, generator: Optional[torch.Generator]) -> None:
        self.norm1.reset_parameters()
        self.mamba.reset_parameters(generator)

    def forward(self, x: torch.Tensor, *, positions: torch.Tensor,
                cache: Optional[dict] = None) -> torch.Tensor:
        if self.grad_boundary and torch.is_grad_enabled():
            x = grad_cast(x)
        h = self.norm1(x)
        if cache is None:
            out, _, _ = self.mamba(h)
        else:
            out, _, conv = self.mamba(h, cache["state"], cache["conv"],
                                      state_out=cache["state"])
            cache["conv"].copy_(conv)
        return x + out


def segment_layers(cfg: ModelConfig, seg: Segment,
                   device: torch.device) -> List[nn.Module]:
    """The layers of one segment, in the reference's order."""
    if seg.kind == "mamba":
        return [MambaLayer(cfg, device) for _ in range(seg.count)]
    return [AttnLayer(cfg, w, device) for w in segment_windows(cfg, seg)]


def init_segment_cache(cfg: ModelConfig, seg: Segment, batch: int,
                       max_len: int, device: torch.device) -> List[dict]:
    """The decode caches of one segment's layers, in layer order: a KV
    ring buffer per attention layer, ``{"state", "conv"}`` zeros per
    Mamba layer."""
    if seg.kind == "mamba":
        return [init_ssm_state(cfg, batch, device) for _ in range(seg.count)]
    return [init_kv_cache(cfg, batch, max_len, w, device)
            for w in segment_windows(cfg, seg)]
