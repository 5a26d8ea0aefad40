"""Dispatch for the selective scan: the kernel on the card, the plain
version on the CPU.

Where the tensors lie decides, and nothing else: CUDA tensors always go
to the hand-written kernel (or raise), CPU tensors always go to the
plain version (:mod:`.ref`).  There is no switch between the two and no
fallback.  Two entries share the kernel: :func:`selective_scan`, the
bare scan, and :func:`mamba_scan`, the Mamba mixer's scan with its
elementwise chain fused in.  ``selective_scan.launches`` counts the
kernel's launches from both, so a run can show that its SSM layers went
through the kernel.

A decode step calls one entry per layer, so the common call is checked
in one pass of attribute reads (:func:`_ready`): tensors already of the
kernel's types, shapes and strides, on one device.  Anything else takes
the slow path, which explains a refusal (:func:`_check`) or converts
what the kernel takes in another form (dt, A and h0 to float32, a
non-unit last stride).

Gradients: the kernel has no backward.  A :func:`mamba_scan` call that
wants a gradient passes ``twin``, a differentiable function of its eight
inputs with the same value (the mixer passes the reference's XLA route,
:func:`repro_torch.models.ssm.mamba_scan_twin`); forward runs the kernel
(or, on the CPU, the plain version) and backward returns the twin's
vector-Jacobian product, recomputed
(:func:`repro_torch._recompute.recompute_vjp`).  Such a call refuses a
carried state (``h0``) or an in-place ``h_out``, and on the card it
needs a twin.
"""
from __future__ import annotations

from typing import Callable, Optional, Sequence, Tuple

import torch

from . import kernel
from ..._recompute import recompute_vjp
from .ref import mamba_scan_ref, selective_scan_ref

_F32 = torch.float32
_KD = (torch.float32, torch.bfloat16)      # kernel.DTYPES
_N = kernel.STATE_SIZES


def _check(named: Sequence[Tuple[str, Optional[torch.Tensor]]],
           want) -> torch.device:
    """Validate tensors and shapes for a refusal's message: ``named`` (name,
    tensor or None), x first, ``want(B, S, I, N)`` the shape of each other
    name; return the one device."""
    named = [(n, t) for n, t in named if t is not None]
    for name, t in named:
        if not isinstance(t, torch.Tensor):
            raise TypeError(f"{name} must be a torch.Tensor, got "
                            f"{type(t).__name__}")
        if not t.is_floating_point():
            raise TypeError(f"{name} must be floating point, got {t.dtype}")
    devs = {t.device for _, t in named}
    if len(devs) != 1:
        raise ValueError(f"{', '.join(n for n, _ in named)} lie on different "
                         f"devices: {sorted(map(str, devs))}")
    x, Bc = named[0][1], dict(named)["Bc"]
    if x.ndim != 3 or Bc.ndim != 3:
        raise ValueError(f"want x (B, S, I) and Bc (B, S, N), got "
                         f"{tuple(x.shape)} and {tuple(Bc.shape)}")
    N = Bc.shape[-1]
    shapes = want(*x.shape, N)
    for name, t in named[1:]:
        if tuple(t.shape) != shapes[name]:
            raise ValueError(f"{name}: want {shapes[name]} for x "
                             f"{tuple(x.shape)} and N={N}, got "
                             f"{tuple(t.shape)}")
    return devs.pop()


def _scan_shapes(B, S, I, N):
    return {"dt": (B, S, I), "Bc": (B, S, N), "Cc": (B, S, N), "A": (I, N),
            "h0": (B, I, N)}


def _fused_shapes(B, S, I, N):
    return {"dt_lin": (B, S, I), "z": (B, S, I), "Bc": (B, S, N),
            "Cc": (B, S, N), "dt_bias": (I,), "D": (I,), "A_log": (I, N),
            "h0": (B, I, N), "h_out": (B, I, N)}


def _cuda(dev: torch.device, what: str) -> None:
    if dev.type != "cuda":
        raise ValueError(f"{what} runs on the CPU or a CUDA device, not "
                         f"{dev}")


def _state_size(N: int) -> None:
    if N not in _N:
        raise ValueError(f"state size {N} is not one of the kernel's {_N}")


def _unit(t: torch.Tensor) -> torch.Tensor:
    """t with unit stride over its last axis (a copy only if not)."""
    return t if t.stride(-1) == 1 else t.contiguous()


def _ready(x, dt, Bc, Cc, A, h0) -> bool:
    """The bare call is the kernel's as it stands: on one CUDA device; x,
    Bc, Cc float32 or bfloat16 (Bc, Cc alike); dt, A, h0 float32; the
    shapes of :func:`_scan_shapes`; unit last strides; A and h0
    contiguous."""
    try:
        B, S, I = x.shape
        N = Bc.shape[2]
        dev = x.device
        return (dev.type == "cuda" and dt.shape == x.shape
                and Bc.shape == (B, S, N) and Cc.shape == Bc.shape
                and A.shape == (I, N) and N in _N
                and x.dtype in _KD and Bc.dtype in _KD
                and Cc.dtype == Bc.dtype and dt.dtype == _F32
                and A.dtype == _F32
                and dt.device == dev and Bc.device == dev
                and Cc.device == dev and A.device == dev
                and x.stride(2) == 1 and dt.stride(2) == 1
                and Bc.stride(2) == 1 and Cc.stride(2) == 1
                and A.is_contiguous()
                and (h0 is None or (h0.shape == (B, I, N)
                                    and h0.dtype == _F32
                                    and h0.device == dev
                                    and h0.is_contiguous())))
    except (AttributeError, TypeError, ValueError, IndexError):
        return False


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
    if not _ready(x, dt, Bc, Cc, A, h0):
        dev = _check([("x", x), ("dt", dt), ("Bc", Bc), ("Cc", Cc),
                      ("A", A), ("h0", h0)], _scan_shapes)
        if dev.type == "cpu":
            return selective_scan_ref(x, dt, Bc, Cc, A, h0)
        _cuda(dev, "selective_scan")
        _state_size(Bc.shape[-1])
        if x.dtype not in _KD or Bc.dtype not in _KD or Cc.dtype != Bc.dtype:
            raise TypeError(f"x, Bc, Cc must be float32 or bfloat16 (Bc and "
                            f"Cc alike), got {x.dtype}, {Bc.dtype}, "
                            f"{Cc.dtype}")
        # B_t and C_t are read through their batch and step strides (slices
        # of the x_proj output need no copy); only the last axis must be
        # unit-stride
        x, Bc, Cc = _unit(x), _unit(Bc), _unit(Cc)
        dt = _unit(dt.to(_F32))
        A = A.to(_F32).contiguous()
        if h0 is not None:
            h0 = h0.to(_F32).contiguous()
    out = kernel.launch(x, dt, Bc, Cc, A, h0)
    selective_scan.launches += 1
    return out


selective_scan.launches = 0


def _fused_ready(x, dt_lin, dt_bias, Bc, Cc, A_log, D, z, h0, h_out):
    """The strides of x, dt_lin, z, Bc and Cc if the fused call is the
    kernel's as it stands, else None: on one CUDA device; x, dt_lin, z,
    Bc, Cc all float32 or all bfloat16; dt_bias, D, A_log, h0, h_out
    float32; the shapes of :func:`_fused_shapes`; unit last strides;
    dt_bias, D, A_log, h0 and h_out contiguous."""
    try:
        B, S, I = xs = x.shape
        N = Bc.shape[2]
        dty, dev = x.dtype, x.device
        st = (x.stride(), dt_lin.stride(), z.stride(), Bc.stride(),
              Cc.stride())
        bsn, bin_ = (B, S, N), (B, I, N)
        ok = (dev.type == "cuda" and dty in _KD and N in _N
              and (dt_lin.shape, z.shape, Bc.shape, Cc.shape, A_log.shape,
                   dt_bias.shape, D.shape)
              == (xs, xs, bsn, bsn, (I, N), (I,), (I,))
              and dt_lin.dtype == z.dtype == Bc.dtype == Cc.dtype == dty
              and A_log.dtype == dt_bias.dtype == D.dtype == _F32
              and st[0][2] == st[1][2] == st[2][2] == st[3][2]
              == st[4][2] == 1
              and dt_lin.device == z.device == Bc.device == Cc.device
              == A_log.device == dt_bias.device == D.device == dev
              and A_log.is_contiguous() and dt_bias.is_contiguous()
              and D.is_contiguous()
              and (h0 is None or (h0.shape == bin_ and h0.dtype == _F32
                                  and h0.device == dev
                                  and h0.is_contiguous()))
              and (h_out is None or h_out is h0
                   or (h_out.shape == bin_ and h_out.dtype == _F32
                       and h_out.device == dev and h_out.is_contiguous())))
        return st if ok else None
    except (AttributeError, TypeError, ValueError, IndexError):
        return None


def mamba_scan(x: torch.Tensor, dt_lin: torch.Tensor, dt_bias: torch.Tensor,
               Bc: torch.Tensor, Cc: torch.Tensor, A_log: torch.Tensor,
               D: torch.Tensor, z: torch.Tensor, *,
               h0: Optional[torch.Tensor] = None,
               h_out: Optional[torch.Tensor] = None,
               twin: Optional[Callable] = None
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The Mamba-1 mixer's scan with its elementwise chain (see
    :func:`~.ref.mamba_scan_ref`): dt = softplus(dt_lin + dt_bias) in
    float32, the scan with A = -exp(A_log) from ``h0`` (zeros when None),
    then out = (y + D x).to(x.dtype) * silu(z).  x, dt_lin, z (B, S, I);
    Bc, Cc (B, S, N); dt_bias, D (I,); A_log (I, N).  Returns (out (B, S,
    I) in x's dtype, h_final (B, I, N) f32).  With ``h_out`` (B, I, N)
    float32, h_final is written into it and it is returned: it may be
    ``h0``, which then carries the state on in place (on the CPU by a
    copy).  On the card x, dt_lin, z, Bc and Cc share one dtype, float32
    or bfloat16 (dt_bias, D, A_log, h0 are taken as float32), z may be a
    strided view (unit stride over I) and N is one of
    ``kernel.STATE_SIZES``.  A call under autograd with an input that
    requires a gradient differentiates ``twin`` in backward (the module
    docstring): it takes no ``h0`` or ``h_out``, and on the card it needs
    a twin."""
    inputs = (x, dt_lin, dt_bias, Bc, Cc, A_log, D, z)
    if torch.is_grad_enabled() and any(isinstance(t, torch.Tensor)
                                       and t.requires_grad for t in inputs):
        return _differentiable(inputs, h0, h_out, twin)
    strides = _fused_ready(x, dt_lin, dt_bias, Bc, Cc, A_log, D, z, h0,
                           h_out)
    if strides is None:
        dev = _check([("x", x), ("Bc", Bc), ("dt_lin", dt_lin), ("z", z),
                      ("Cc", Cc), ("dt_bias", dt_bias), ("D", D),
                      ("A_log", A_log), ("h0", h0), ("h_out", h_out)],
                     _fused_shapes)
        if dev.type == "cpu":
            out, h = mamba_scan_ref(x, dt_lin, dt_bias, Bc, Cc, A_log, D, z,
                                    h0)
            if h_out is None:
                return out, h
            return out, h_out.copy_(h)
        _cuda(dev, "mamba_scan")
        _state_size(Bc.shape[-1])
        if x.dtype not in _KD or any(t.dtype != x.dtype
                                     for t in (dt_lin, z, Bc, Cc)):
            raise TypeError(f"x, dt_lin, z, Bc, Cc must all be float32 or all "
                            f"bfloat16, got {x.dtype}, {dt_lin.dtype}, "
                            f"{z.dtype}, {Bc.dtype}, {Cc.dtype}")
        if h_out is not None and (h_out.dtype != _F32
                                  or not h_out.is_contiguous()):
            raise TypeError(f"h_out must be a contiguous float32 tensor, got "
                            f"{h_out.dtype}")
        x, dt_lin, z, Bc, Cc = map(_unit, (x, dt_lin, z, Bc, Cc))
        dt_bias, D, A_log = (t.to(_F32).contiguous()
                             for t in (dt_bias, D, A_log))
        if h0 is not None:
            h0 = h0.to(_F32).contiguous()
    out = kernel.launch_fused(x, dt_lin, dt_bias, Bc, Cc, A_log, D, z, h0,
                              h_out, strides=strides)
    selective_scan.launches += 1
    return out


def _differentiable(inputs, h0, h_out, twin):
    """:func:`mamba_scan` under autograd: the forward as without it, the
    backward ``twin``'s vector-Jacobian product."""
    if h0 is not None or h_out is not None:
        raise ValueError("mamba_scan cannot take a gradient through a "
                         "carried state: a call that wants one passes no "
                         "h0 and no h_out")
    dev = _check([("x", inputs[0]), ("Bc", inputs[3]),
                  ("dt_lin", inputs[1]), ("z", inputs[7]),
                  ("Cc", inputs[4]), ("dt_bias", inputs[2]),
                  ("D", inputs[6]), ("A_log", inputs[5])], _fused_shapes)
    if twin is None:
        if dev.type == "cpu":
            return mamba_scan_ref(*inputs)
        raise ValueError("mamba_scan on the card has no backward of its "
                         "own: a call that wants a gradient must pass twin=, "
                         "a differentiable function of its eight inputs")
    return recompute_vjp(lambda *t: mamba_scan(*t), twin, inputs)
