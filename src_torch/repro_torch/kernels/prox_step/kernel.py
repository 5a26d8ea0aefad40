"""Bind the CUDA prox-step kernel: ``prox_step_launch`` of the gradient
accumulator's library (``mtl_grad/csrc/mtl_grad.cu``).

The step is the accumulator with another epilogue, so it has no source
of its own: it binds the second entry point of the one library, built
once for both kernels (``SOURCES``), and launches with the same
:func:`~repro_torch.kernels.mtl_grad.kernel.plan`.  Pointers and the
stream go as ``c_void_p``, sizes as ``c_int``, the four step scalars as
``c_float`` (kernel arguments: no device read, no host sync).
:func:`launch` assumes the checks of
:func:`repro_torch.kernels.prox_step.ops.prox_step` have passed.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from ..mtl_grad import kernel as grad_kernel

SOURCE = grad_kernel.SOURCE
SOURCES = {grad_kernel.LIBRARY: SOURCE}
MAX_P = grad_kernel.MAX_P

X_DTYPES = grad_kernel.X_DTYPES
LOSS_CODES = grad_kernel.LOSS_CODES


@functools.cache
def _entry():
    fn = grad_kernel.library().prox_step_launch
    fn.argtypes = [ctypes.c_void_p, ctypes.c_int,        # X, x_dtype
                   ctypes.c_void_p, ctypes.c_void_p,     # y, W
                   ctypes.c_void_p, ctypes.c_void_p,     # Z, Q
                   ctypes.c_void_p,                      # out
                   ctypes.c_int, ctypes.c_int,           # L, n
                   ctypes.c_int, ctypes.c_int,           # p, loss
                   ctypes.c_float, ctypes.c_float,       # eta, rho
                   ctypes.c_float, ctypes.c_float,       # inv_m, l2
                   ctypes.c_int, ctypes.c_int,           # split, tile_rows
                   ctypes.c_int,                         # stages
                   ctypes.c_void_p]                      # stream
    fn.restype = ctypes.c_int
    return fn


def build() -> None:
    """Compile and load the library now (it is otherwise built at the
    first launch)."""
    _entry()


def launch(X: torch.Tensor, y: torch.Tensor, W: torch.Tensor,
           Z: torch.Tensor, Q: torch.Tensor, eta: float, rho: float,
           inv_m: float, l2: float, loss: str,
           plan: grad_kernel.Plan | None = None) -> torch.Tensor:
    """One launch on the current stream of X's device; returns (L, p) f32.
    ``plan`` defaults to the accumulator's; a check may force another."""
    L, n, p = X.shape
    fn = _entry()
    pl = plan or grad_kernel.plan_for(X)
    with torch.cuda.device(X.device):
        out = torch.empty((L, p), dtype=torch.float32, device=X.device)
        err = fn(X.data_ptr(), X_DTYPES[X.dtype], y.data_ptr(), W.data_ptr(),
                 Z.data_ptr(), Q.data_ptr(), out.data_ptr(), L, n, p,
                 LOSS_CODES[loss], eta, rho, inv_m, l2, pl.split,
                 pl.tile_rows, pl.stages,
                 torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"prox_step kernel launch failed with CUDA error "
                           f"{err} (L={L}, n={n}, p={p}, loss={loss}, {pl})")
    return out
