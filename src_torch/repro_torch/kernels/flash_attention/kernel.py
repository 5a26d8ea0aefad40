"""Build and bind the CUDA flash-attention kernels, and choose between
them.

Two routes, each its own source with a plain C interface, compiled with
``nvcc`` into a shared library at its first launch
(:mod:`repro_torch.kernels._build`) and called through ``ctypes``:
pointers and the stream go as ``c_void_p``, sizes and flags as
``c_int``, the softcap and the scale as ``c_float`` (kernel arguments:
no device read, no host sync).

- ``"wgmma"`` (``csrc/flash_attention_wgmma.cu``): bf16 prefill on the
  tensor cores, for bf16 calls with at least ``WGMMA_MIN_ROWS`` query
  rows (Sq * group).
- ``"cuda_cores"`` (``csrc/flash_attention.cu``): f32 FMAs, for every
  other call (f32, and decode with its key split).

:func:`plan` picks the route; :func:`launch` assumes the checks of
:func:`repro_torch.kernels.flash_attention.ops.flash_attention` have
passed.
"""
from __future__ import annotations

import ctypes
import functools
import pathlib
from typing import NamedTuple, Optional, Tuple

import torch

from .. import _build

CSRC = pathlib.Path(__file__).resolve().parent / "csrc"
SOURCE = CSRC / "flash_attention.cu"
WGMMA_SOURCE = CSRC / "flash_attention_wgmma.cu"
SOURCES = {"flash_attention": SOURCE, "flash_attention_wgmma": WGMMA_SOURCE}
ROUTES = ("wgmma", "cuda_cores")
HEAD_DIMS = (64, 128, 256)       # both sources' instantiations
DTYPES = {torch.float32: 0, torch.bfloat16: 1}
ROWS_PER_CTA = (8, 64)              # kWarps * RPW in the source, RPW 1 or 8
TILE_K = 32                         # kTileK in the source
MIN_TILES_PER_SPLIT = 8
WGMMA_ROWS = 128                    # kRows in the wgmma source
WGMMA_TILE_K = 64                   # kBc in the wgmma source
WGMMA_MIN_ROWS = 64                 # one consumer warpgroup's rows


@functools.cache
def _entry():
    fn = _build.load("flash_attention", SOURCE).flash_attention_launch
    fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p,      # q, k
                   ctypes.c_void_p, ctypes.c_void_p,      # v, q_pos
                   ctypes.c_void_p, ctypes.c_void_p,      # k_pos, out
                   ctypes.c_void_p, ctypes.c_int,         # part, dtype
                   ctypes.c_int, ctypes.c_int,            # B, Sq
                   ctypes.c_int, ctypes.c_int,            # Sk, H
                   ctypes.c_int, ctypes.c_int,            # Hkv, hd
                   ctypes.c_int,                          # rows per CTA
                   ctypes.c_int, ctypes.c_int,            # causal, window
                   ctypes.c_float, ctypes.c_float,        # softcap, scale
                   ctypes.c_int, ctypes.c_int,            # n_split, tiles
                   ctypes.c_void_p]                       # stream
    fn.restype = ctypes.c_int
    return fn


@functools.cache
def _wgmma_entry():
    fn = _build.load("flash_attention_wgmma",
                     WGMMA_SOURCE).flash_attention_wgmma_launch
    fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p,      # q, k
                   ctypes.c_void_p, ctypes.c_void_p,      # v, q_pos
                   ctypes.c_void_p, ctypes.c_void_p,      # k_pos, out
                   ctypes.c_void_p,                       # tile summaries
                   ctypes.c_int, ctypes.c_int,            # B, Sq
                   ctypes.c_int, ctypes.c_int,            # Sk, H
                   ctypes.c_int, ctypes.c_int,            # Hkv, hd
                   ctypes.c_int, ctypes.c_int,            # causal, window
                   ctypes.c_float, ctypes.c_float,        # softcap, scale
                   ctypes.c_void_p]                       # stream
    fn.restype = ctypes.c_int
    return fn


def build() -> None:
    """Compile and load both libraries now (each is otherwise built at
    its first launch)."""
    _entry()
    _wgmma_entry()


class Plan(NamedTuple):
    """One launch: its route, query rows per CTA, CTAs over query blocks
    and KV heads, key splits and key tiles per split."""
    route: str
    rows: int
    ctas: int
    n_split: int
    tiles_per_split: int


def route(dtype: torch.dtype, Sq: int, H: int, Hkv: int, hd: int) -> str:
    """``"wgmma"`` for a bf16 call with at least ``WGMMA_MIN_ROWS`` query
    rows, a head dim of ``HEAD_DIMS`` and a group that fits the row block;
    ``"cuda_cores"`` for every other call (f32, decode)."""
    group = H // Hkv
    if (dtype == torch.bfloat16 and Sq * group >= WGMMA_MIN_ROWS
            and hd in HEAD_DIMS and group <= WGMMA_ROWS):
        return "wgmma"
    return "cuda_cores"


def plan(B: int, Sq: int, Sk: int, H: int, Hkv: int, hd: int,
         dtype: torch.dtype, n_sm: int) -> Plan:
    """Route and grid of one launch.  On the ``"wgmma"`` route a CTA
    takes ``WGMMA_ROWS // group`` queries times the group's heads (126 or
    120 rows at group 9 or 12) against every key tile of
    ``WGMMA_TILE_K`` keys.  On the ``"cuda_cores"`` route a CTA takes 8
    rows (one a warp) when the call's Sq * group rows fit in 8 (a decode
    step), else 64; the keys are split only when the query CTAs alone
    leave most SMs idle (decode), so that about two CTAs for each of the
    card's ``n_sm`` SMs read the K/V slots, each split at least
    ``MIN_TILES_PER_SPLIT`` tiles long."""
    group = H // Hkv
    if route(dtype, Sq, H, Hkv, hd) == "wgmma":
        bq = WGMMA_ROWS // group
        return Plan("wgmma", bq * group, -(-Sq // bq) * B * Hkv, 1,
                    max(1, -(-Sk // WGMMA_TILE_K)))
    rows = ROWS_PER_CTA[0] if Sq * group <= ROWS_PER_CTA[0] \
        else ROWS_PER_CTA[1]
    ctas = -(-Sq // (rows // group)) * B * Hkv
    n_tiles = max(1, -(-Sk // TILE_K))
    want = max(1, min(2 * n_sm // ctas, n_tiles // MIN_TILES_PER_SPLIT))
    per = -(-n_tiles // want)
    return Plan("cuda_cores", rows, ctas, -(-n_tiles // per), per)


def launch(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
           q_pos: torch.Tensor, k_pos: torch.Tensor, causal: bool,
           window: Optional[int], softcap: Optional[float],
           scale: float) -> Tuple[torch.Tensor, str]:
    """One launch on the current stream of q's device; returns the output
    in q's shape and dtype, and the route it took."""
    B, Sq, H, hd = q.shape
    Sk, Hkv = k.shape[1], k.shape[2]
    how = plan(B, Sq, Sk, H, Hkv, hd, q.dtype,
               torch.cuda.get_device_properties(q.device).multi_processor_count)
    if how.route == "wgmma":
        return _launch_wgmma(q, k, v, q_pos, k_pos, causal, window, softcap,
                             scale, how.tiles_per_split), how.route
    _, rows, ctas, n_split, per = how
    fn = _entry()
    with torch.cuda.device(q.device):
        out = torch.empty_like(q)
        part = None
        if n_split > 1:
            part = torch.empty(n_split * ctas * rows * (hd + 2),
                               dtype=torch.float32, device=q.device)
        err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), q_pos.data_ptr(),
                 k_pos.data_ptr(), out.data_ptr(),
                 None if part is None else part.data_ptr(), DTYPES[q.dtype],
                 B, Sq, Sk, H, Hkv, hd, rows, int(causal),
                 0 if window is None else int(window),
                 0.0 if not softcap else float(softcap), float(scale),
                 n_split, per, torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(
            f"flash_attention kernel launch failed with CUDA error {err} "
            f"(B={B}, Sq={Sq}, Sk={Sk}, H={H}, Hkv={Hkv}, hd={hd}, "
            f"dtype={q.dtype}, n_split={n_split})")
    return out, how.route


def _launch_wgmma(q, k, v, q_pos, k_pos, causal, window, softcap, scale,
                  n_ktiles) -> torch.Tensor:
    """The tensor-core route: its tile-summary pre-pass and the kernel,
    with the pre-pass's scratch (one int4 per batch row and key tile)."""
    B, Sq, H, hd = q.shape
    Sk, Hkv = k.shape[1], k.shape[2]
    fn = _wgmma_entry()
    with torch.cuda.device(q.device):
        out = torch.empty_like(q)
        tiles = torch.empty(B * n_ktiles * 4, dtype=torch.int32,
                            device=q.device)
        err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), q_pos.data_ptr(),
                 k_pos.data_ptr(), out.data_ptr(), tiles.data_ptr(),
                 B, Sq, Sk, H, Hkv, hd, int(causal),
                 0 if window is None else int(window),
                 0.0 if not softcap else float(softcap), float(scale),
                 torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(
            f"flash_attention tensor-core launch failed with CUDA error "
            f"{err} (B={B}, Sq={Sq}, Sk={Sk}, H={H}, Hkv={Hkv}, hd={hd})")
    return out

