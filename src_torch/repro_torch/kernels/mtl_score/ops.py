"""Dispatch for the fused scorer: the kernel on the card, the plain
version on the CPU.

Where the tensors lie decides, and nothing else: CUDA tensors always go
to the hand-written kernel (or raise), CPU tensors always go to
:func:`~.ref.mtl_score_ref`.  There is no switch between the two and no
fallback.  ``mtl_score.launches`` counts kernel launches, so a run can
show that its scoring went through the kernel.
"""
from __future__ import annotations

import torch

from . import kernel
from .ref import mtl_score_ref


def _check(U, C, S, ids, X) -> torch.device:
    """Validate what the kernel takes; return the one device."""
    for name, t in (("U", U), ("C", C), ("S", S), ("ids", ids), ("X", X)):
        if not isinstance(t, torch.Tensor):
            raise TypeError(f"{name} must be a torch.Tensor, got {type(t).__name__}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    devs = {t.device for t in (U, C, S, ids, X)}
    if len(devs) != 1:
        raise ValueError(f"U, C, S, ids, X lie on different devices: "
                         f"{sorted(map(str, devs))}")
    if U.ndim != 2 or C.ndim != 2 or X.ndim != 2 or ids.ndim != 1:
        raise ValueError(f"want U (p, r), C (m, r), ids (B,), X (B, p); got "
                         f"{tuple(U.shape)}, {tuple(C.shape)}, "
                         f"{tuple(ids.shape)}, {tuple(X.shape)}")
    (p, r), (m, rc), (B, px) = U.shape, C.shape, X.shape
    if rc != r or px != p or ids.shape[0] != B or tuple(S.shape) != (m, 1):
        raise ValueError(f"shape mismatch: U {tuple(U.shape)}, C "
                         f"{tuple(C.shape)}, S {tuple(S.shape)}, ids "
                         f"{tuple(ids.shape)}, X {tuple(X.shape)}")
    if not 1 <= r <= kernel.MAX_RANK:
        raise ValueError(f"rank r={r} outside the kernel's 1..{kernel.MAX_RANK}")
    if m < 1:
        raise ValueError("empty code table")
    if U.dtype not in kernel.BASIS_DTYPES or X.dtype not in kernel.BASIS_DTYPES:
        raise TypeError(f"U and X must be float32 or bfloat16, got "
                        f"{U.dtype} and {X.dtype}")
    if C.dtype not in kernel.CODE_DTYPES:
        raise TypeError(f"C must be float32, int8 or float8_e4m3fn, got {C.dtype}")
    if S.dtype != torch.float32 or ids.dtype != torch.int32:
        raise TypeError(f"S must be float32 and ids int32, got {S.dtype} "
                        f"and {ids.dtype}")
    return devs.pop()


def mtl_score(U: torch.Tensor, C: torch.Tensor, S: torch.Tensor,
              ids: torch.Tensor, X: torch.Tensor) -> torch.Tensor:
    """Fused serving scores: U (p, r) f32/bf16; C (m, r) f32/int8/fp8;
    S (m, 1) f32 per-code scales; ids (B,) int32, clamped to [0, m-1];
    X (B, p) f32/bf16 -> (B,) f32.  r is at most ``kernel.MAX_RANK``."""
    dev = _check(U, C, S, ids, X)
    if dev.type == "cpu":
        return mtl_score_ref(U, C, S, ids, X)
    if dev.type != "cuda":
        raise ValueError(f"mtl_score runs on the CPU or a CUDA device, "
                         f"not {dev}")
    if X.shape[0] == 0:
        return torch.empty(0, dtype=torch.float32, device=dev)
    out = kernel.launch(U, C, S, ids, X)
    mtl_score.launches += 1
    return out


mtl_score.launches = 0
