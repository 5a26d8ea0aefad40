"""Build and bind the CUDA prox-step kernel (``csrc/prox_step.cu``).

The source has a plain C interface, so it is compiled with ``nvcc`` into
a shared library at the first launch (:mod:`repro_torch.kernels._build`)
and called through ``ctypes``: pointers and the stream go as
``c_void_p``, sizes as ``c_int``, the four step scalars as ``c_float``
(kernel arguments: no device read, no host sync).  :func:`launch`
assumes the checks of :func:`repro_torch.kernels.prox_step.ops.prox_step`
have passed.
"""
from __future__ import annotations

import ctypes
import functools
import pathlib

import torch

from .. import _build

SOURCE = pathlib.Path(__file__).resolve().parent / "csrc" / "prox_step.cu"
MAX_P = 16384               # kMaxP in the source

X_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
LOSS_CODES = {"squared": 0, "logistic": 1}


@functools.cache
def _entry():
    fn = _build.load("prox_step", SOURCE).prox_step_launch
    fn.argtypes = [ctypes.c_void_p, ctypes.c_int,        # X, x_dtype
                   ctypes.c_void_p, ctypes.c_void_p,     # y, W
                   ctypes.c_void_p, ctypes.c_void_p,     # Z, Q
                   ctypes.c_void_p,                      # out
                   ctypes.c_int, ctypes.c_int,           # L, n
                   ctypes.c_int, ctypes.c_int,           # p, loss
                   ctypes.c_float, ctypes.c_float,       # eta, rho
                   ctypes.c_float, ctypes.c_float,       # inv_m, l2
                   ctypes.c_void_p]                      # stream
    fn.restype = ctypes.c_int
    return fn


def build() -> None:
    """Compile and load the library now (it is otherwise built at the
    first launch)."""
    _entry()


def launch(X: torch.Tensor, y: torch.Tensor, W: torch.Tensor,
           Z: torch.Tensor, Q: torch.Tensor, eta: float, rho: float,
           inv_m: float, l2: float, loss: str) -> torch.Tensor:
    """One launch on the current stream of X's device; returns (L, p) f32."""
    L, n, p = X.shape
    fn = _entry()
    with torch.cuda.device(X.device):
        out = torch.empty((L, p), dtype=torch.float32, device=X.device)
        err = fn(X.data_ptr(), X_DTYPES[X.dtype], y.data_ptr(), W.data_ptr(),
                 Z.data_ptr(), Q.data_ptr(), out.data_ptr(), L, n, p,
                 LOSS_CODES[loss], eta, rho, inv_m, l2,
                 torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"prox_step kernel launch failed with CUDA error "
                           f"{err} (L={L}, n={n}, p={p}, loss={loss})")
    return out
