"""Plain PyTorch attention with explicit positions.

The reference's ``_sdpa_naive`` with ``_mask_bias``
(``repro.models.attention``) in the (B, S, H, hd) layout, with GQA
grouping, in float32: scores ``q·k·scale``, the logit softcap
``c·tanh(s/c)``, the position mask, a softmax over the keys that count,
the product with ``v`` in float32, the result cast to ``q``'s dtype.  A
row where no key counts gives 0, as the reference's Pallas kernel and
its oracle ``repro.kernels.flash_attention.ref`` do (the reference's
naive path gives a near-uniform mean there instead; no such row occurs
on the serving path, where each query's own key always counts).

:func:`attention_ref` is the CPU path of
:func:`repro_torch.kernels.flash_attention.ops.flash_attention` and the
oracle the CUDA kernel is held against on the card.
"""
from __future__ import annotations

from typing import Optional

import torch

NEG_INF = -2.0 ** 30


def key_mask(q_pos: torch.Tensor, k_pos: torch.Tensor, causal: bool,
             window: Optional[int]) -> torch.Tensor:
    """(B, Sq, Sk) bool: key ``k`` counts for query ``q`` when its
    position is a written slot (``k_pos >= 0``), not in the future (if
    causal) and inside the window (if any)."""
    qp = q_pos[:, :, None].to(torch.int64)
    kp = k_pos[:, None, :].to(torch.int64)
    ok = kp >= 0
    if causal:
        ok = ok & (kp <= qp)
    if window is not None:
        ok = ok & (kp > qp - window)
    return ok


def attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                  q_pos: torch.Tensor, k_pos: torch.Tensor,
                  causal: bool = True, window: Optional[int] = None,
                  softcap: Optional[float] = None,
                  scale: Optional[float] = None) -> torch.Tensor:
    """q: (B, Sq, H, hd); k, v: (B, Sk, Hkv, hd) with H a multiple of
    Hkv; q_pos (B, Sq), k_pos (B, Sk) integer.  Returns (B, Sq, H, hd)
    in q's dtype, computed in float32 (float64 for float64 inputs)."""
    B, Sq, H, hd = q.shape
    Hkv = k.shape[2]
    group = H // Hkv
    scale = hd ** -0.5 if scale is None else scale
    acc = torch.float64 if q.dtype == torch.float64 else torch.float32
    qg = q.reshape(B, Sq, Hkv, group, hd).to(acc)
    s = torch.einsum("bqhgd,bkhd->bhgqk", qg, k.to(acc)) * scale
    if softcap:
        s = softcap * torch.tanh(s / softcap)
    ok = key_mask(q_pos, k_pos, causal, window)[:, None, None]
    s = s.masked_fill(~ok, NEG_INF)
    p = torch.exp(s - s.amax(-1, keepdim=True)).masked_fill(~ok, 0.0)
    denom = p.sum(-1, keepdim=True).clamp_min(1e-30)
    out = torch.einsum("bhgqk,bkhd->bqhgd", p / denom, v.to(acc))
    return out.reshape(B, Sq, H, v.shape[-1]).to(q.dtype)
