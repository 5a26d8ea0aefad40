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
oracle the CUDA kernels are held against on the card.
:func:`key_tile_summary` and :func:`tile_states` are the plain version
of the tensor-core kernel's pre-pass and tile skip rule
(``csrc/flash_attention_wgmma.cu``).
"""
from __future__ import annotations

from typing import Optional

import torch

NEG_INF = -2.0 ** 30
INT32_MAX, INT32_MIN = 2 ** 31 - 1, -2 ** 31
SKIP, WHOLE, MASKED = 0, 1, 2        # key tile states


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


def key_tile_summary(k_pos: torch.Tensor, tile: int) -> torch.Tensor:
    """(B, ceil(Sk / tile), 3) int64: the least and largest live key
    position (``k_pos >= 0``) of each tile of ``tile`` slots, and their
    count; a tile with no live key gives (``INT32_MAX``, ``INT32_MIN``,
    0)."""
    B, Sk = k_pos.shape
    n = -(-Sk // tile)
    kp = torch.full((B, n * tile), -1, dtype=torch.int64)
    kp[:, :Sk] = k_pos.to(torch.int64)
    kp = kp.view(B, n, tile)
    live = kp >= 0
    lo = torch.where(live, kp, INT32_MAX).amin(-1)
    hi = torch.where(live, kp, INT32_MIN).amax(-1)
    return torch.stack([lo, hi, live.sum(-1)], -1)


def tile_states(q_pos: torch.Tensor, k_pos: torch.Tensor, bq: int,
                tile: int, causal: bool, window: Optional[int]
                ) -> torch.Tensor:
    """(B, ceil(Sq / bq), ceil(Sk / tile)) int64: what the tensor-core
    kernel does with each key tile for each block of ``bq`` queries, from
    the block's (min, max) query position and the tile's
    :func:`key_tile_summary`: ``SKIP`` (no live key, every key after the
    block's last query, or every key at or before its first query -
    window), ``WHOLE`` (``tile`` live keys that count for every query of
    the block: no per-element mask) or ``MASKED``."""
    B, Sq = q_pos.shape
    nq = -(-Sq // bq)
    qp = q_pos.to(torch.int64)
    pad = nq * bq - Sq
    qmin = torch.cat([qp, qp.new_full((B, pad), INT32_MAX)], 1)
    qmax = torch.cat([qp, qp.new_full((B, pad), INT32_MIN)], 1)
    qmin = qmin.view(B, nq, bq).amin(-1)[:, :, None]
    qmax = qmax.view(B, nq, bq).amax(-1)[:, :, None]
    lo, hi, n = key_tile_summary(k_pos, tile)[:, None].unbind(-1)
    skip = n == 0
    whole = n == tile
    if causal:
        skip = skip | (lo > qmax)
        whole = whole & (hi <= qmin)
    if window is not None:
        skip = skip | (hi <= qmin - window)
        whole = whole & (lo > qmax - window)
    return torch.where(skip, SKIP, torch.where(whole, WHOLE, MASKED))
