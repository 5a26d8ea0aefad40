"""Build and bind the CUDA scoring kernel (``csrc/mtl_score.cu``).

The source has a plain C interface, so it is compiled with ``nvcc`` into
a shared library at the first launch (:mod:`repro_torch.kernels._build`)
and called through ``ctypes``: pointers and the stream go as
``c_void_p``, sizes as ``c_int``.  :func:`launch` assumes the checks of
:func:`repro_torch.kernels.mtl_score.ops.mtl_score` have passed.
"""
from __future__ import annotations

import ctypes
import functools
import pathlib

import torch

from .. import _build

SOURCE = pathlib.Path(__file__).resolve().parent / "csrc" / "mtl_score.cu"
MAX_RANK = 8                # kMaxR in the source

BASIS_DTYPES = {torch.float32: 0, torch.bfloat16: 1}   # X and U
CODE_DTYPES = {torch.float32: 0, torch.int8: 1, torch.float8_e4m3fn: 2}


@functools.cache
def _entry():
    fn = _build.load("mtl_score", SOURCE).mtl_score_launch
    fn.argtypes = [ctypes.c_void_p, ctypes.c_int,        # U, u_dtype
                   ctypes.c_void_p, ctypes.c_int,        # C, c_dtype
                   ctypes.c_void_p, ctypes.c_void_p,     # S, ids
                   ctypes.c_void_p, ctypes.c_int,        # X, x_dtype
                   ctypes.c_void_p,                      # out
                   ctypes.c_int, ctypes.c_int,           # B, p
                   ctypes.c_int, ctypes.c_int,           # m, r
                   ctypes.c_void_p]                      # stream
    fn.restype = ctypes.c_int
    return fn


def build() -> None:
    """Compile and load the library now (it is otherwise built at the
    first launch)."""
    _entry()


def launch(U: torch.Tensor, C: torch.Tensor, S: torch.Tensor,
           ids: torch.Tensor, X: torch.Tensor) -> torch.Tensor:
    """One launch on the current stream of X's device; returns (B,) f32."""
    B, p = X.shape
    m, r = C.shape
    fn = _entry()
    with torch.cuda.device(X.device):
        out = torch.empty(B, dtype=torch.float32, device=X.device)
        err = fn(U.data_ptr(), BASIS_DTYPES[U.dtype],
                 C.data_ptr(), CODE_DTYPES[C.dtype],
                 S.data_ptr(), ids.data_ptr(),
                 X.data_ptr(), BASIS_DTYPES[X.dtype],
                 out.data_ptr(), B, p, m, r,
                 torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"mtl_score kernel launch failed with CUDA error "
                           f"{err} (B={B}, p={p}, m={m}, r={r})")
    return out
