"""Build and bind the CUDA selective-scan kernel (``csrc/ssm_scan.cu``).

The source has a plain C interface, so it is compiled with ``nvcc`` into
a shared library at the first launch (:mod:`repro_torch.kernels._build`)
and called through ``ctypes``: pointers and the stream go as
``c_void_p``, sizes and type codes as ``c_int``, strides as
``c_int64``.  :func:`launch` assumes the checks of
:func:`repro_torch.kernels.ssm_scan.ops.selective_scan` have passed.
"""
from __future__ import annotations

import ctypes
import functools
import pathlib
from typing import Optional, Tuple

import torch

from .. import _build

SOURCE = pathlib.Path(__file__).resolve().parent / "csrc" / "ssm_scan.cu"
STATE_SIZES = (4, 8, 16)          # the source's instantiations of N
DTYPES = {torch.float32: 0, torch.bfloat16: 1}   # of x and of B_t, C_t


@functools.cache
def _entry():
    fn = _build.load("ssm_scan", SOURCE).ssm_scan_launch
    fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p,      # x, dt
                   ctypes.c_void_p, ctypes.c_void_p,      # Bc, Cc
                   ctypes.c_void_p, ctypes.c_void_p,      # A, h0
                   ctypes.c_void_p, ctypes.c_void_p,      # y, h_out
                   ctypes.c_int, ctypes.c_int,            # x, B/C dtype
                   ctypes.c_int, ctypes.c_int,            # B, S
                   ctypes.c_int, ctypes.c_int,            # I, N
                   ctypes.c_int64, ctypes.c_int64,        # Bc strides
                   ctypes.c_int64, ctypes.c_int64,        # Cc strides
                   ctypes.c_void_p]                       # stream
    fn.restype = ctypes.c_int
    return fn


def build() -> None:
    """Compile and load the library now (it is otherwise built at the
    first launch)."""
    _entry()


def launch(x: torch.Tensor, dt: torch.Tensor, Bc: torch.Tensor,
           Cc: torch.Tensor, A: torch.Tensor, h0: Optional[torch.Tensor]
           ) -> Tuple[torch.Tensor, torch.Tensor]:
    """One launch on the current stream of x's device; returns y (B, S, I)
    and h_final (B, I, N), both float32."""
    B, S, I = x.shape
    N = Bc.shape[-1]
    fn = _entry()
    with torch.cuda.device(x.device):
        y = torch.empty((B, S, I), dtype=torch.float32, device=x.device)
        h = torch.empty((B, I, N), dtype=torch.float32, device=x.device)
        err = fn(x.data_ptr(), dt.data_ptr(), Bc.data_ptr(), Cc.data_ptr(),
                 A.data_ptr(), None if h0 is None else h0.data_ptr(),
                 y.data_ptr(), h.data_ptr(), DTYPES[x.dtype],
                 DTYPES[Bc.dtype], B, S, I, N, Bc.stride(0), Bc.stride(1),
                 Cc.stride(0), Cc.stride(1),
                 torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(
            f"ssm_scan kernel launch failed with CUDA error {err} (B={B}, "
            f"S={S}, I={I}, N={N}, x {x.dtype}, B/C {Bc.dtype})")
    return y, h
