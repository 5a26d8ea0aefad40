"""Build and bind the CUDA gradient kernel (``csrc/mtl_grad.cu``).

The source has a plain C interface, so it is compiled with ``nvcc`` into
a shared library at the first launch (:mod:`repro_torch.kernels._build`)
and called through ``ctypes``: pointers and the stream go as
``c_void_p``, sizes as ``c_int``.  :func:`launch` assumes the checks of
:func:`repro_torch.kernels.mtl_grad.ops.task_gradients` have passed.
"""
from __future__ import annotations

import ctypes
import functools
import pathlib

import torch

from .. import _build

SOURCE = pathlib.Path(__file__).resolve().parent / "csrc" / "mtl_grad.cu"
MAX_P = 16384               # kMaxP in the source

X_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
LOSS_CODES = {"squared": 0, "logistic": 1}


@functools.cache
def _entry():
    fn = _build.load("mtl_grad", SOURCE).mtl_grad_launch
    fn.argtypes = [ctypes.c_void_p, ctypes.c_int,        # X, x_dtype
                   ctypes.c_void_p, ctypes.c_void_p,     # y, W
                   ctypes.c_void_p,                      # G
                   ctypes.c_int, ctypes.c_int,           # m, n
                   ctypes.c_int, ctypes.c_int,           # p, loss
                   ctypes.c_void_p]                      # stream
    fn.restype = ctypes.c_int
    return fn


def build() -> None:
    """Compile and load the library now (it is otherwise built at the
    first launch)."""
    _entry()


def launch(X: torch.Tensor, y: torch.Tensor, W: torch.Tensor,
           loss: str) -> torch.Tensor:
    """One launch on the current stream of X's device; returns (m, p) f32."""
    m, n, p = X.shape
    fn = _entry()
    with torch.cuda.device(X.device):
        G = torch.empty((m, p), dtype=torch.float32, device=X.device)
        err = fn(X.data_ptr(), X_DTYPES[X.dtype], y.data_ptr(), W.data_ptr(),
                 G.data_ptr(), m, n, p, LOSS_CODES[loss],
                 torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"mtl_grad kernel launch failed with CUDA error "
                           f"{err} (m={m}, n={n}, p={p}, loss={loss})")
    return G
