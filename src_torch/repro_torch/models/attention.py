"""Attention: GQA/MQA, RoPE, sliding window, logit softcap, KV caches.

Port of the standard path of ``repro.models.attention`` (projections,
RoPE, the ring-buffer cache, the prefill-over-fresh-keys rule).

Every attention call goes through one function, :func:`sdpa`, and from
there through :func:`repro_torch.kernels.flash_attention.flash_attention`:
the hand-written kernel for tensors on the card, its plain version for
tensors on the CPU.  The reference selects one of four implementations
with ``cfg.attn_impl`` (``naive``, ``chunked``, ``pallas``, ``auto``);
they compute one function of (q, k, v, q_pos, k_pos), except that the
reference's Pallas kernel ignores the positions and assumes 0..S-1, so
its ring-buffer decode step attends to the wrong slots (ROADMAP Queue 3).
The port's kernel takes the positions and computes the ``naive``
semantics in prefill and decode alike, so ``cfg.attn_impl`` is accepted
and does not change the result.

A KV cache is a dict ``{"k": (B, slots, Hkv, hd), "v": ..., "pos": (B,
slots) int32}``; a sliding-window layer keeps ``min(window, max_len)``
slots as a ring buffer, and an empty slot sits at position ``-10**9``.
Unlike the reference, which returns a new cache, the port writes the new
entries into the cache's buffers in place (the serving engine owns them;
no second copy of a 2 GB cache per step).  Attention is causal
self-attention; MLA raises, and cross-attention (whisper) is not
reachable (its segment raises in :mod:`.blocks`).
"""
from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from ..configs.base import ModelConfig
from ..kernels.flash_attention import ops as fa_ops
from .common import apply_rope, dense_param, dtype_of, init_dense

EMPTY_POS = -10 ** 9


def sdpa(q, k, v, *, q_pos, k_pos, cfg: ModelConfig,
         window: Optional[int]) -> torch.Tensor:
    """Causal scaled dot-product attention at explicit positions, with the
    config's logit softcap (``cfg.attn_impl`` is not read: see the module
    docstring)."""
    return fa_ops.flash_attention(
        q, k, v, q_pos=q_pos, k_pos=k_pos, causal=True, window=window,
        softcap=cfg.attn_logit_softcap)


def init_kv_cache(cfg: ModelConfig, batch: int, max_len: int,
                  window: Optional[int], device: torch.device) -> dict:
    """Ring-buffer cache; sliding-window layers cap the buffer at window."""
    dt = dtype_of(cfg)
    hd = cfg.resolved_head_dim
    slots = min(window, max_len) if window else max_len
    shape = (batch, slots, cfg.n_kv_heads, hd)
    return {"k": torch.zeros(shape, dtype=dt, device=device),
            "v": torch.zeros(shape, dtype=dt, device=device),
            "pos": torch.full((batch, slots), EMPTY_POS, dtype=torch.int32,
                              device=device)}


def update_kv_cache(cache: dict, k: torch.Tensor, v: torch.Tensor,
                    positions: torch.Tensor) -> dict:
    """Write entries at ring slots ``pos % slots``, in place.  When more
    entries arrive than the ring holds (windowed prefill), only the tail
    is written: older entries would be overwritten anyway, and the tail's
    slots are distinct."""
    slots = cache["k"].shape[1]
    B, S = positions.shape
    if S > slots:
        k, v, positions = k[:, -slots:], v[:, -slots:], positions[:, -slots:]
    idx = positions.to(torch.int64) % slots
    rows = torch.arange(B, device=idx.device)[:, None]
    cache["k"][rows, idx] = k
    cache["v"][rows, idx] = v
    cache["pos"][rows, idx] = positions.to(torch.int32)
    return cache


class Attention(nn.Module):
    """Self-attention with GQA, RoPE and the serving caches."""

    def __init__(self, cfg: ModelConfig, device: torch.device):
        super().__init__()
        if cfg.mla:
            raise NotImplementedError(
                "MLA attention (deepseek-v3) is not ported: ROADMAP Queue 1 "
                "item 11c")
        self.cfg = cfg
        hd, dt = cfg.resolved_head_dim, dtype_of(cfg)
        self.wq = dense_param(cfg.d_model, cfg.n_heads * hd, dt, device)
        self.wk = dense_param(cfg.d_model, cfg.n_kv_heads * hd, dt, device)
        self.wv = dense_param(cfg.d_model, cfg.n_kv_heads * hd, dt, device)
        self.wo = dense_param(cfg.n_heads * hd, cfg.d_model, dt, device)

    def reset_parameters(self, generator: Optional[torch.Generator]) -> None:
        for w in (self.wq, self.wk, self.wv):
            init_dense(w, generator)
        init_dense(self.wo, generator, std=self.wo.shape[0] ** -0.5)

    def forward(self, x: torch.Tensor, *, positions: torch.Tensor,
                cache: Optional[dict] = None,
                window: Optional[int] = None) -> torch.Tensor:
        """Causal self-attention of x (B, S, D) at positions (B, S), the
        absolute positions of x's tokens.  Without a cache, attends over x
        itself.  With one, the new keys are written into it; a prefill
        (S > 1) attends over its fresh keys (a ring narrower than S cannot
        serve the early queries), a decode step (S == 1) over the cache."""
        cfg = self.cfg
        B, S, _ = x.shape
        hd = cfg.resolved_head_dim
        q = (x @ self.wq).reshape(B, S, cfg.n_heads, hd)
        k = (x @ self.wk).reshape(B, S, cfg.n_kv_heads, hd)
        v = (x @ self.wv).reshape(B, S, cfg.n_kv_heads, hd)
        if cfg.rope:
            q = apply_rope(q, positions, cfg.rope_theta)
            k = apply_rope(k, positions, cfg.rope_theta)
        if cache is not None:
            update_kv_cache(cache, k, v, positions)
        if cache is None or S > 1:
            out = sdpa(q, k, v, q_pos=positions, k_pos=positions, cfg=cfg,
                       window=window)
        else:
            out = sdpa(q, cache["k"], cache["v"], q_pos=positions,
                       k_pos=cache["pos"], cfg=cfg, window=window)
        return out.reshape(B, S, cfg.n_heads * hd) @ self.wo
