"""Build and bind the CUDA scoring kernel (``csrc/mtl_score.cu``), and
plan its launch.

The source has a plain C interface, so it is compiled with ``nvcc`` into
a shared library at the first launch (:mod:`repro_torch.kernels._build`)
and called through ``ctypes``: pointers and the stream go as
``c_void_p``, sizes as ``c_int``.  :func:`plan` decides how a launch
cuts a row's p over the warps of a CTA; :func:`lane_elements` is the
kernel's own cut, written out so that the CPU tests can check it.
:func:`launch` assumes the checks of
:func:`repro_torch.kernels.mtl_score.ops.mtl_score` have passed.
"""
from __future__ import annotations

import ctypes
import functools
import pathlib
from typing import NamedTuple

import torch

from .. import _build

SOURCE = pathlib.Path(__file__).resolve().parent / "csrc" / "mtl_score.cu"
MAX_RANK = 8                # kMaxR in the source
WARPS = 8                   # kWarps: a CTA's warps
WARPS_PER_ROW = (1, 2, 4, 8)
ROWS_PER_WARP = (1, 4)      # rows a warp takes at once (kMaxRowsPerWarp)

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
                   ctypes.c_int, ctypes.c_int,           # warps a row, rows a warp
                   ctypes.c_void_p]                      # stream
    fn.restype = ctypes.c_int
    return fn


class Plan(NamedTuple):
    warps_per_row: int  # warps of one CTA that share a row's p
    rows_per_warp: int  # rows a warp takes at once, sharing U's loads
    rows_per_cta: int   # WARPS // warps_per_row * rows_per_warp
    ctas: int


@functools.cache
def plan(B: int, n_sm: int) -> Plan:
    """The launch for a wave of B rows on a card of ``n_sm`` SMs:
    ``ROWS_PER_WARP[-1]`` rows a warp (each U row read once for them)
    with the fewest warps a row whose CTAs cover the SMs, as at B=4096
    (2 warps a row, 16 rows a CTA, 256 CTAs); where no such plan covers
    the SMs, one row a warp and the fewest warps a row that do, or all
    ``WARPS`` (B=256: 8 warps a row, 256 CTAs; B=64: 64 CTAs).  A row stays in one CTA: split over the CTAs of a cluster, its
    sums meeting in distributed shared memory, it was slower on the
    card."""
    for rw in reversed(ROWS_PER_WARP):
        for spr in WARPS_PER_ROW:
            rows = WARPS // spr * rw
            if -(-B // rows) >= n_sm:
                return Plan(spr, rw, rows, -(-B // rows))
    return Plan(WARPS, 1, 1, B)


def lane_elements(p: int, x_bytes: int, pl: Plan, aligned: bool = True
                  ) -> list[list[int]]:
    """For each of a row's ``warps_per_row * 32`` lanes (g = warp * 32 +
    lane), the elements of the row it adds, in its order: the 16-byte
    chunks g, g + n_lanes, ... when the launch's rows are 16-byte aligned
    (X aligned, p * x_bytes a multiple of 16), each chunk's elements in
    order, then the elements past the last whole chunk (every element, if
    the rows are not aligned) g, g + n_lanes, ...  The cut is the same
    for each of a warp's ``rows_per_warp`` rows."""
    n_lanes = pl.warps_per_row * 32
    vec = 16 // x_bytes
    vec_end = (p // vec) * vec if aligned else 0
    return [[j for c in range(g, vec_end // vec, n_lanes)
             for j in range(c * vec, c * vec + vec)]
            + list(range(vec_end + g, p, n_lanes)) for g in range(n_lanes)]


@functools.cache
def _sm_count(device: torch.device) -> int:
    return torch.cuda.get_device_properties(device).multi_processor_count


def build() -> None:
    """Compile and load the library now (it is otherwise built at the
    first launch)."""
    _entry()


def launch(U: torch.Tensor, C: torch.Tensor, S: torch.Tensor,
           ids: torch.Tensor, X: torch.Tensor, pl: Plan | None = None
           ) -> torch.Tensor:
    """One launch on the current stream of X's device (with ``pl``, or
    :func:`plan`'s); returns (B,) f32."""
    B, p = X.shape
    m, r = C.shape
    pl = pl or plan(B, _sm_count(X.device))
    fn = _entry()
    with torch.cuda.device(X.device):
        out = torch.empty(B, dtype=torch.float32, device=X.device)
        err = fn(U.data_ptr(), BASIS_DTYPES[U.dtype],
                 C.data_ptr(), CODE_DTYPES[C.dtype],
                 S.data_ptr(), ids.data_ptr(),
                 X.data_ptr(), BASIS_DTYPES[X.dtype],
                 out.data_ptr(), B, p, m, r, pl.warps_per_row, pl.rows_per_warp,
                 torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"mtl_score kernel launch failed with CUDA error "
                           f"{err} (B={B}, p={p}, m={m}, r={r}, {pl})")
    return out
