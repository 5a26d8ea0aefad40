"""Dispatch for attention with explicit positions: the kernel on the
card, the plain version on the CPU.

Where the tensors lie decides, and nothing else: CUDA tensors always go
to the hand-written kernel (or raise), CPU tensors always go to
:func:`~.ref.attention_ref`.  There is no switch between the two and no
fallback.  ``flash_attention.launches`` counts kernel launches, so a run
can show that its attention went through the kernel.

Gradients: the kernel has no backward, and its output, made by a ctypes
launch, has no ``grad_fn``.  A call that wants a gradient passes
``twin``, a differentiable function of (q, k, v) with the same value
(the model passes the reference's XLA route,
:func:`repro_torch.models.attention.sdpa_twin`); forward runs the
kernel (or, on the CPU, the plain version) and backward returns the
twin's vector-Jacobian product, recomputed
(:func:`repro_torch._recompute.recompute_vjp`).  On the card such a call
without a twin raises.
"""
from __future__ import annotations

from typing import Callable, Optional

import torch

from . import kernel
from ..._recompute import recompute_vjp
from .ref import attention_ref


def _check(q, k, v, q_pos, k_pos) -> torch.device:
    """Validate what the kernel takes; return the one device."""
    named = (("q", q), ("k", k), ("v", v), ("q_pos", q_pos), ("k_pos", k_pos))
    for name, t in named:
        if not isinstance(t, torch.Tensor):
            raise TypeError(f"{name} must be a torch.Tensor, got "
                            f"{type(t).__name__}")
    devs = {t.device for _, t in named}
    if len(devs) != 1:
        raise ValueError(f"q, k, v, q_pos, k_pos lie on different devices: "
                         f"{sorted(map(str, devs))}")
    if q.ndim != 4 or k.ndim != 4 or v.shape != k.shape:
        raise ValueError(f"want q (B, Sq, H, hd), k and v (B, Sk, Hkv, hd); "
                         f"got {[tuple(t.shape) for t in (q, k, v)]}")
    B, Sq, H, hd = q.shape
    _, Sk, Hkv, hd_k = k.shape
    if k.shape[0] != B or hd_k != hd or Hkv < 1 or H % Hkv:
        raise ValueError(f"q {tuple(q.shape)} and k {tuple(k.shape)} do not "
                         f"group: need the same B and hd, H a multiple of Hkv")
    if tuple(q_pos.shape) != (B, Sq) or tuple(k_pos.shape) != (B, Sk):
        raise ValueError(f"want q_pos {(B, Sq)} and k_pos {(B, Sk)}, got "
                         f"{tuple(q_pos.shape)} and {tuple(k_pos.shape)}")
    if q_pos.is_floating_point() or k_pos.is_floating_point():
        raise TypeError("positions must be integers")
    if not (q.dtype == k.dtype == v.dtype) or q.dtype not in kernel.DTYPES:
        raise TypeError(f"q, k, v must share float32 or bfloat16, got "
                        f"{q.dtype}, {k.dtype}, {v.dtype}")
    return devs.pop()


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    q_pos: torch.Tensor, k_pos: torch.Tensor,
                    causal: bool = True, window: Optional[int] = None,
                    softcap: Optional[float] = None,
                    scale: Optional[float] = None,
                    prefix_len: Optional[torch.Tensor] = None,
                    twin: Optional[Callable] = None) -> torch.Tensor:
    """Attention of q (B, Sq, H, hd) over k, v (B, Sk, Hkv, hd) with GQA
    grouping, at the positions q_pos (B, Sq) and k_pos (B, Sk): the
    reference's ``_sdpa_naive`` with ``_mask_bias`` (key j counts when
    ``k_pos >= 0``, ``k_pos <= q_pos`` if causal, ``k_pos > q_pos -
    window`` if windowed), with the logit softcap, f32 accumulation and
    the output in q's dtype; a row where no key counts is 0.  On the card
    hd is one of ``kernel.HEAD_DIMS`` and H/Hkv at most 64, and a bf16
    call with at least 64 query rows (Sq * H/Hkv) runs on the tensor
    cores and a call of at most 8 (a decode step) on the decode kernel
    (``kernel.route``).  The prefix-LM mask (``prefix_len``) is not
    supported.  A call under autograd with q, k or v requiring a
    gradient differentiates ``twin(q, k, v)`` in backward (the module
    docstring); on the card it needs one."""
    if prefix_len is not None:
        raise NotImplementedError(
            "the prefix-LM mask (paligemma) is not ported: ROADMAP Queue 1 "
            "item 11c")
    dev = _check(q, k, v, q_pos, k_pos)
    scale = q.shape[-1] ** -0.5 if scale is None else float(scale)
    if window is not None and window < 1:
        raise ValueError(f"window must be positive, got {window}")
    grad = torch.is_grad_enabled() and any(t.requires_grad
                                           for t in (q, k, v))
    if dev.type == "cpu":
        def plain(q, k, v):
            return attention_ref(q, k, v, q_pos=q_pos, k_pos=k_pos,
                                 causal=causal, window=window,
                                 softcap=softcap, scale=scale)
        if grad and twin is not None:
            return recompute_vjp(plain, twin, (q, k, v))
        return plain(q, k, v)
    if dev.type != "cuda":
        raise ValueError(f"flash_attention runs on the CPU or a CUDA device, "
                         f"not {dev}")
    B, Sq, H, hd = q.shape
    if hd not in kernel.HEAD_DIMS:
        raise ValueError(f"head dim {hd} is not one of the kernel's "
                         f"{kernel.HEAD_DIMS}")
    if H // k.shape[2] > kernel.ROWS_PER_CTA:
        raise ValueError(f"group {H // k.shape[2]} exceeds the kernel's "
                         f"{kernel.ROWS_PER_CTA}")
    if grad and twin is None:
        raise ValueError("flash_attention on the card has no backward of "
                         "its own: a call that wants a gradient must pass "
                         "twin=, a differentiable function of (q, k, v)")
    if Sq == 0 or B == 0:
        return torch.empty_like(q)
    q_pos = q_pos.to(torch.int32).contiguous()
    k_pos = k_pos.to(torch.int32).contiguous()

    def launch(q, k, v):
        q, k, v = q.contiguous(), k.contiguous(), v.contiguous()
        if any(t.data_ptr() % 16 for t in (q, k, v)):
            raise ValueError("q, k and v must start on a 16-byte boundary")
        out, route = kernel.launch(q, k, v, q_pos, k_pos, causal, window,
                                   softcap, scale)
        flash_attention.launches += 1
        flash_attention.launches_by_route[route] += 1
        return out

    if grad:
        return recompute_vjp(launch, twin, (q, k, v))
    return launch(q, k, v)


flash_attention.launches = 0
flash_attention.launches_by_route = dict.fromkeys(kernel.ROUTES, 0)
