"""Dispatch for the selective scan: the kernel on the card, the plain
version on the CPU.

Where the tensors lie decides, and nothing else: CUDA tensors always go
to the hand-written kernel (or raise), CPU tensors always go to
:func:`~.ref.selective_scan_ref`.  There is no switch between the two and
no fallback.  ``selective_scan.launches`` counts kernel launches, so a
run can show that its SSM layers went through the kernel.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from . import kernel
from .ref import selective_scan_ref


def _check(x, dt, Bc, Cc, A, h0) -> torch.device:
    """Validate what the kernel takes; return the one device."""
    named = [("x", x), ("dt", dt), ("Bc", Bc), ("Cc", Cc), ("A", A)]
    if h0 is not None:
        named.append(("h0", h0))
    for name, t in named:
        if not isinstance(t, torch.Tensor):
            raise TypeError(f"{name} must be a torch.Tensor, got "
                            f"{type(t).__name__}")
        if not t.is_floating_point():
            raise TypeError(f"{name} must be floating point, got {t.dtype}")
    devs = {t.device for _, t in named}
    if len(devs) != 1:
        raise ValueError(f"x, dt, Bc, Cc, A{', h0' if h0 is not None else ''}"
                         f" lie on different devices: "
                         f"{sorted(map(str, devs))}")
    if x.ndim != 3 or Bc.ndim != 3:
        raise ValueError(f"want x (B, S, I) and Bc (B, S, N), got "
                         f"{tuple(x.shape)} and {tuple(Bc.shape)}")
    B, S, I = x.shape
    N = Bc.shape[-1]
    want = {"dt": (B, S, I), "Bc": (B, S, N), "Cc": (B, S, N), "A": (I, N),
            "h0": (B, I, N)}
    for name, t in named:
        if name != "x" and tuple(t.shape) != want[name]:
            raise ValueError(f"{name}: want {want[name]} for x "
                             f"{tuple(x.shape)} and N={N}, got "
                             f"{tuple(t.shape)}")
    return devs.pop()


def selective_scan(x: torch.Tensor, dt: torch.Tensor, Bc: torch.Tensor,
                   Cc: torch.Tensor, A: torch.Tensor, *,
                   h0: Optional[torch.Tensor] = None
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The Mamba-1 selective scan h_t = exp(dt_t A) h_{t-1} + (dt_t x_t)
    B_t^T, y_t = h_t C_t over x, dt (B, S, I), Bc, Cc (B, S, N) and A
    (I, N), from the state ``h0`` (B, I, N) (zeros when None), in
    float32.  Returns (y (B, S, I) f32, h_final (B, I, N) f32); ``h0`` is
    not written.  On the card x, Bc and Cc are float32 or bfloat16 (dt,
    A and h0 are taken as float32) and N is one of
    ``kernel.STATE_SIZES``."""
    dev = _check(x, dt, Bc, Cc, A, h0)
    if dev.type == "cpu":
        return selective_scan_ref(x, dt, Bc, Cc, A, h0)
    if dev.type != "cuda":
        raise ValueError(f"selective_scan runs on the CPU or a CUDA device, "
                         f"not {dev}")
    N = Bc.shape[-1]
    if N not in kernel.STATE_SIZES:
        raise ValueError(f"state size {N} is not one of the kernel's "
                         f"{kernel.STATE_SIZES}")
    if x.dtype not in kernel.DTYPES or Bc.dtype not in kernel.DTYPES \
            or Cc.dtype != Bc.dtype:
        raise TypeError(f"x, Bc, Cc must be float32 or bfloat16 (Bc and Cc "
                        f"alike), got {x.dtype}, {Bc.dtype}, {Cc.dtype}")
    x = x.contiguous()
    dt = dt.to(torch.float32).contiguous()
    A = A.to(torch.float32).contiguous()
    if h0 is not None:
        h0 = h0.to(torch.float32).contiguous()
    # B_t and C_t are read through their batch and step strides (slices
    # of the x_proj output need no copy); only the state axis must be
    # unit-stride
    Bc = Bc if Bc.stride(-1) == 1 else Bc.contiguous()
    Cc = Cc if Cc.stride(-1) == 1 else Cc.contiguous()
    if any(t.data_ptr() % 16 for t in (A, h0) if t is not None):
        raise ValueError("A and h0 must start on a 16-byte boundary")
    y, h = kernel.launch(x, dt, Bc, Cc, A, h0)
    selective_scan.launches += 1
    return y, h


selective_scan.launches = 0
