"""Build and bind the CUDA selective-scan kernel (``csrc/ssm_scan.cu``).

The source has a plain C interface, so it is compiled with ``nvcc`` into
a shared library at the first launch (:mod:`repro_torch.kernels._build`)
and called through ``ctypes``.  Two entry points share one kernel
template: :func:`launch` (the bare scan, ``ssm_scan_launch``) and
:func:`launch_fused` (the Mamba mixer's scan with its softplus prologue
and D-skip/SiLU-gate epilogue, ``mamba_scan_launch``).

Both assume the checks of :mod:`repro_torch.kernels.ssm_scan.ops` have
passed, and are lean, since a decode step calls one per layer: each call
packs its pointers, sizes, strides and stream into one ``int64`` record
(the source's ``LaunchArgs``, field order :data:`FIELDS`) and crosses to
C as one pointer; the stream is read with
``torch._C._cuda_getCurrentRawStream``, and the device is switched only
when x's is not the current one.  The source refuses misaligned state
pointers itself, before it launches (:data:`MISALIGNED`: a
ValueError here).
"""
from __future__ import annotations

import array
import ctypes
import functools
import pathlib
from typing import Optional, Tuple

import torch

from .. import _build

SOURCE = pathlib.Path(__file__).resolve().parent / "csrc" / "ssm_scan.cu"
STATE_SIZES = (4, 8, 16)          # the source's instantiations of N
LANE_STATES = (4, 8)              # ... and of P, states a lane (P <= N)
CHANNELS = 64                     # channels of one row a block
DTYPES = {torch.float32: 0, torch.bfloat16: 1}   # of x and of B_t, C_t
MISALIGNED = 716                  # cudaErrorMisalignedAddress
FIELDS = ("x", "dt", "z", "dt_bias", "Bc", "Cc", "A", "D", "h0", "out",
          "h_out", "dtype", "bc_dtype", "B", "S", "I", "N", "P", "x_sb",
          "x_st", "d_sb", "d_st", "z_sb", "z_st", "b_sb", "b_st", "c_sb",
          "c_st", "stream")
_F32 = torch.float32
_bound = {}


def _bind():
    lib = _build.load("ssm_scan", SOURCE)
    for name in ("ssm_scan_launch", "mamba_scan_launch"):
        fn = getattr(lib, name)
        fn.argtypes = [ctypes.c_void_p]
        fn.restype = ctypes.c_int
        _bound[name] = fn
    return _bound


def build() -> None:
    """Compile and load the library now (it is otherwise built at the
    first launch)."""
    _bind()


def _call(name: str, record) -> int:
    buf = array.array("q", record)
    assert len(buf) == len(FIELDS)
    return (_bound.get(name) or _bind()[name])(buf.buffer_info()[0])


@functools.cache
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


@functools.cache
def plan(B: int, I: int, N: int, n_sm: int) -> int:
    """States a lane, P: 8 (Q = N / 8 lanes a channel) when the grid of
    B·⌈I/64⌉ blocks reaches 6 blocks an SM, else 4 (twice the lanes, for
    small grids).  On the H100 the fused entry at the served prefill
    (1024 blocks) runs faster at P = 8, and at B = 1, 2 and 4 (128-512
    blocks) faster at P = 4 (``PERF.md``; ``chip_smoke.py`` phase 11
    times both on each side)."""
    if N < 8:
        return 4
    blocks = B * -(-I // CHANNELS)
    return 8 if blocks >= 6 * n_sm else 4


def _raise(err: int, what: str, B, S, I, N, P, dtype) -> None:
    """A misaligned A, h0 or h_out is the caller's error (ValueError; the
    source refuses it before it launches), anything else the card's."""
    if err == MISALIGNED:
        raise ValueError(f"{what}: A, h0 and h_out must start on a 16-byte "
                         f"boundary")
    raise RuntimeError(f"{what} kernel launch failed: CUDA error {err} "
                       f"(B={B}, S={S}, I={I}, N={N}, P={P}, {dtype})")


def launch(x: torch.Tensor, dt: torch.Tensor, Bc: torch.Tensor,
           Cc: torch.Tensor, A: torch.Tensor, h0: Optional[torch.Tensor],
           P: Optional[int] = None) -> Tuple[torch.Tensor, torch.Tensor]:
    """One bare scan on the current stream of x's device; returns y (B, S,
    I) and h_final (B, I, N), both float32.  ``P`` forces the states a
    lane (phase 11 of ``chip_smoke.py`` checks and times each)."""
    dev = x.device
    if dev.index != torch._C._cuda_getDevice():
        with torch.cuda.device(dev):
            return launch(x, dt, Bc, Cc, A, h0, P)
    B, S, I = x.shape
    N = Bc.shape[2]
    P = P or plan(B, I, N, _sm_count(dev.index))
    y = torch.empty((B, S, I), dtype=_F32, device=dev)
    h = torch.empty((B, I, N), dtype=_F32, device=dev)
    xs, ds, bs, cs = x.stride(), dt.stride(), Bc.stride(), Cc.stride()
    err = _call("ssm_scan_launch", (
        x.data_ptr(), dt.data_ptr(), 0, 0, Bc.data_ptr(), Cc.data_ptr(),
        A.data_ptr(), 0, 0 if h0 is None else h0.data_ptr(), y.data_ptr(),
        h.data_ptr(), DTYPES[x.dtype], DTYPES[Bc.dtype], B, S, I, N, P,
        xs[0], xs[1], ds[0], ds[1], 0, 0, bs[0], bs[1], cs[0], cs[1],
        torch._C._cuda_getCurrentRawStream(dev.index)))
    if err:
        _raise(err, "ssm_scan", B, S, I, N, P, f"x {x.dtype}, B/C {Bc.dtype}")
    return y, h


def launch_fused(x: torch.Tensor, dt_lin: torch.Tensor,
                 dt_bias: torch.Tensor, Bc: torch.Tensor, Cc: torch.Tensor,
                 A_log: torch.Tensor, D: torch.Tensor, z: torch.Tensor,
                 h0: Optional[torch.Tensor], h_out: Optional[torch.Tensor],
                 P: Optional[int] = None, strides=None
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """One fused mixer scan on the current stream of x's device; returns
    out (B, S, I) in x's dtype and h_final (B, I, N) float32, written
    into ``h_out`` when given (it may be ``h0``).  ``P`` as in
    :func:`launch`; ``strides``, if given, are x's, dt_lin's, z's, Bc's
    and Cc's (read by the caller's check)."""
    dev = x.device
    if dev.index != torch._C._cuda_getDevice():
        with torch.cuda.device(dev):
            return launch_fused(x, dt_lin, dt_bias, Bc, Cc, A_log, D, z, h0,
                                h_out, P, strides)
    B, S, I = x.shape
    N = Bc.shape[2]
    P = P or plan(B, I, N, _sm_count(dev.index))
    out = torch.empty((B, S, I), dtype=x.dtype, device=dev)
    if h_out is None:
        h_out = torch.empty((B, I, N), dtype=_F32, device=dev)
    xs, ds, zs, bs, cs = strides or (x.stride(), dt_lin.stride(), z.stride(),
                                     Bc.stride(), Cc.stride())
    dtype = DTYPES[x.dtype]
    err = _call("mamba_scan_launch", (
        x.data_ptr(), dt_lin.data_ptr(), z.data_ptr(), dt_bias.data_ptr(),
        Bc.data_ptr(), Cc.data_ptr(), A_log.data_ptr(), D.data_ptr(),
        0 if h0 is None else h0.data_ptr(), out.data_ptr(), h_out.data_ptr(),
        dtype, dtype, B, S, I, N, P, xs[0], xs[1], ds[0], ds[1], zs[0],
        zs[1], bs[0], bs[1], cs[0], cs[1],
        torch._C._cuda_getCurrentRawStream(dev.index)))
    if err:
        _raise(err, "mamba_scan", B, S, I, N, P, f"{x.dtype}")
    return out, h_out
