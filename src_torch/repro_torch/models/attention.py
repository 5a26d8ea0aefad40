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
semantics in prefill and decode alike, so ``cfg.attn_impl`` does not
change the forward result.

Training differentiates the reference's XLA routes: the kernel has no
backward, so a call under autograd hands the kernel :func:`sdpa_twin`,
the route the reference's ``sdpa`` takes (``naive`` or ``chunked``;
under ``auto`` or ``pallas`` the chunked route once Sq·Sk reaches
4096², else the naive one), and backward returns its vector-Jacobian
product, recomputed (``_sdpa_naive``, ``_sdpa_chunked``, ``_mask_bias``
and ``_softcap`` are ports of the reference's).

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

import functools
from typing import Optional

import torch
from torch import nn

from ..configs.base import ModelConfig
from ..kernels.flash_attention import ops as fa_ops
from .common import apply_rope, dense_param, dtype_of, init_dense

EMPTY_POS = -10 ** 9


NEG_INF = -2.0 ** 30     # the reference's large negative: a fully masked
                         # row renormalizes instead of giving NaN
CHUNKED_FROM = 4096 * 4096   # Sq·Sk from which ``auto`` takes the chunked route


def sdpa(q, k, v, *, q_pos, k_pos, cfg: ModelConfig,
         window: Optional[int]) -> torch.Tensor:
    """Causal scaled dot-product attention at explicit positions, with the
    config's logit softcap, through the kernel; under autograd its
    gradient is :func:`sdpa_twin`'s (see the module docstring)."""
    twin = (functools.partial(sdpa_twin, q_pos=q_pos, k_pos=k_pos, cfg=cfg,
                              window=window)
            if torch.is_grad_enabled() else None)
    return fa_ops.flash_attention(
        q, k, v, q_pos=q_pos, k_pos=k_pos, causal=True, window=window,
        softcap=cfg.attn_logit_softcap, twin=twin)


# --- the reference's XLA routes, the kernel's differentiable twins -----------

def _mask_bias(q_pos, k_pos, causal: bool,
               window: Optional[int]) -> torch.Tensor:
    """Additive float32 bias (B, Sq, Sk): 0 where key k counts for query
    q (a written slot, not in the future if causal, inside the window),
    ``NEG_INF`` elsewhere."""
    qp = q_pos[..., :, None]
    kp = k_pos[..., None, :]
    ok = kp >= 0
    if causal:
        ok = ok & (kp <= qp)
    if window is not None:
        ok = ok & (kp > qp - window)
    return torch.where(ok, 0.0, NEG_INF).to(torch.float32)


def _softcap(scores: torch.Tensor, cap: Optional[float]) -> torch.Tensor:
    return cap * torch.tanh(scores / cap) if cap else scores


def _sdpa_naive(q, k, v, bias, scale, softcap) -> torch.Tensor:
    """The reference's naive route: float32 scores over all keys, softcap,
    bias, softmax, probabilities cast to v's dtype for the product with
    v.  q (B, Sq, H, hd), k and v (B, Sk, Hkv, hd), GQA by grouping."""
    B, Sq, H, hd = q.shape
    Hkv, dv = k.shape[2], v.shape[-1]
    qg = q.reshape(B, Sq, Hkv, H // Hkv, hd)
    scores = torch.einsum("bqhgd,bkhd->bhgqk", qg.to(torch.float32),
                          k.to(torch.float32)) * scale
    scores = _softcap(scores, softcap) + bias[:, None, None]
    probs = torch.softmax(scores, dim=-1)
    out = torch.einsum("bhgqk,bkhd->bqhgd", probs.to(v.dtype), v)
    return out.reshape(B, Sq, H, dv)


def _sdpa_chunked(q, k, v, q_pos, k_pos, scale, softcap, causal: bool,
                  window: Optional[int], chunk: int) -> torch.Tensor:
    """The reference's chunked route: an online softmax over key chunks
    of ``chunk`` (the last padded with empty slots), float32 throughout,
    the output in q's dtype."""
    f32 = torch.float32
    B, Sq, H, hd = q.shape
    Sk, Hkv, dv = k.shape[1], k.shape[2], v.shape[-1]
    group = H // Hkv
    n_chunks = -(-Sk // chunk)
    pad = n_chunks * chunk - Sk
    if pad:
        k = torch.cat([k, k.new_zeros((B, pad) + k.shape[2:])], 1)
        v = torch.cat([v, v.new_zeros((B, pad) + v.shape[2:])], 1)
        k_pos = torch.cat([k_pos, k_pos.new_full((B, pad), EMPTY_POS)], 1)
    qg = (q.reshape(B, Sq, Hkv, group, hd) * scale).to(f32)
    m = torch.full((B, Hkv, group, Sq), NEG_INF, dtype=f32, device=q.device)
    l = torch.zeros((B, Hkv, group, Sq), dtype=f32, device=q.device)
    acc = torch.zeros((B, Hkv, group, Sq, dv), dtype=f32, device=q.device)
    for c in range(0, n_chunks * chunk, chunk):
        s = torch.einsum("bqhgd,bkhd->bhgqk", qg, k[:, c:c + chunk].to(f32))
        s = _softcap(s, softcap)
        s = s + _mask_bias(q_pos, k_pos[:, c:c + chunk], causal,
                           window)[:, None, None]
        m_new = torch.maximum(m, s.amax(-1))
        alpha = torch.exp(m - m_new)
        pexp = torch.exp(s - m_new[..., None])
        l = l * alpha + pexp.sum(-1)
        acc = acc * alpha[..., None] + torch.einsum(
            "bhgqk,bkhd->bhgqd", pexp, v[:, c:c + chunk].to(f32))
        m = m_new
    out = acc / torch.clamp(l[..., None], min=1e-30)
    return out.permute(0, 3, 1, 2, 4).reshape(B, Sq, H, dv).to(q.dtype)


def sdpa_twin(q, k, v, *, q_pos, k_pos, cfg: ModelConfig,
              window: Optional[int], causal: bool = True,
              scale: Optional[float] = None) -> torch.Tensor:
    """The reference's ``sdpa`` on its XLA routes, differentiable:
    ``cfg.attn_impl`` "naive" or "chunked" as given; "auto" (and
    "pallas", whose kernel the reference cannot differentiate) chunked
    from Sq·Sk ≥ 4096², naive below, with ``cfg.attn_chunk``."""
    scale = q.shape[-1] ** -0.5 if scale is None else scale
    impl = cfg.attn_impl
    if impl not in ("naive", "chunked"):
        impl = ("chunked" if q.shape[1] * k.shape[1] >= CHUNKED_FROM
                else "naive")
    if impl == "chunked":
        return _sdpa_chunked(q, k, v, q_pos, k_pos, scale,
                             cfg.attn_logit_softcap, causal, window,
                             cfg.attn_chunk)
    return _sdpa_naive(q, k, v, _mask_bias(q_pos, k_pos, causal, window),
                       scale, cfg.attn_logit_softcap)


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
