"""Build and bind the CUDA flash-attention kernels, and choose between
them.

Three routes, each its own source with a plain C interface, compiled with
``nvcc`` into a shared library at its first launch
(:mod:`repro_torch.kernels._build`) and called through ``ctypes``:
pointers and the stream go as ``c_void_p``, sizes and flags as
``c_int``, the softcap and the scale as ``c_float`` (kernel arguments:
no device read, no host sync).

- ``"wgmma"`` (``csrc/flash_attention_wgmma.cu``): bf16 prefill on the
  tensor cores, for bf16 calls with at least ``WGMMA_MIN_ROWS`` query
  rows (Sq * group).
- ``"decode"`` (``csrc/flash_decode.cu``): every call whose Sq * group
  query rows fit in ``DECODE_ROWS[-1]`` (a decode step), f32 or bf16:
  keys split over CTAs and warps, K/V through a ``cp.async`` ring.
- ``"cuda_cores"`` (``csrc/flash_attention.cu``): f32 FMAs, for every
  other call (f32 prefill, and bf16 calls of 9 to 63 rows).

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
DECODE_SOURCE = CSRC / "flash_decode.cu"
SOURCES = {"flash_attention": SOURCE, "flash_attention_wgmma": WGMMA_SOURCE,
           "flash_decode": DECODE_SOURCE}
ROUTES = ("wgmma", "decode", "cuda_cores")
HEAD_DIMS = (64, 128, 256)       # every source's instantiations
DTYPES = {torch.float32: 0, torch.bfloat16: 1}
ROWS_PER_CTA = 64                   # kWarps * RPW in the CUDA-core source
TILE_K = 32                         # kTileK in the source
MIN_TILES_PER_SPLIT = 8
DECODE_ROWS = (2, 8)                # RMAX, the decode source's instantiations
DECODE_WARPS = 8                    # kWarps in the decode source
DECODE_TILE_BYTES = 16384           # kTileBytes: K (and V) bytes of a tile
DECODE_MAX_KEYS = 2048              # kMaxKeys: keys of one split
DECODE_CTAS_PER_SM = 1              # of the two that fit (~107 KB each):
                                    # one a SM read faster (serve_ab --sweep)
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


@functools.cache
def _decode_entry():
    fn = _build.load("flash_decode", DECODE_SOURCE).flash_decode_launch
    fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p,      # q, k
                   ctypes.c_void_p, ctypes.c_void_p,      # v, q_pos
                   ctypes.c_void_p, ctypes.c_void_p,      # k_pos, out
                   ctypes.c_void_p, ctypes.c_int,         # part, dtype
                   ctypes.c_int, ctypes.c_int,            # B, Sq
                   ctypes.c_int, ctypes.c_int,            # Sk, H
                   ctypes.c_int, ctypes.c_int,            # Hkv, hd
                   ctypes.c_int,                          # rows (RMAX)
                   ctypes.c_int, ctypes.c_int,            # causal, window
                   ctypes.c_float, ctypes.c_float,        # softcap, scale
                   ctypes.c_int, ctypes.c_int,            # n_split, tiles
                   ctypes.c_void_p]                       # stream
    fn.restype = ctypes.c_int
    return fn


def build() -> None:
    """Compile and load the three libraries now (each is otherwise built
    at its first launch)."""
    _entry()
    _wgmma_entry()
    _decode_entry()


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
    ``"decode"`` for a call of at most ``DECODE_ROWS[-1]`` query rows (Sq
    * group) and a head dim of ``HEAD_DIMS``; ``"cuda_cores"`` for every
    other call (f32 prefill, bf16 calls of 9 to 63 rows)."""
    group = H // Hkv
    if (dtype == torch.bfloat16 and Sq * group >= WGMMA_MIN_ROWS
            and hd in HEAD_DIMS and group <= WGMMA_ROWS):
        return "wgmma"
    if Sq * group <= DECODE_ROWS[-1] and hd in HEAD_DIMS:
        return "decode"
    return "cuda_cores"


def decode_tile_keys(hd: int, dtype: torch.dtype) -> int:
    """Keys of one tile of the decode route: ``DECODE_TILE_BYTES`` of K."""
    return DECODE_TILE_BYTES // (hd * torch.finfo(dtype).bits // 8)


def plan(B: int, Sq: int, Sk: int, H: int, Hkv: int, hd: int,
         dtype: torch.dtype, n_sm: int) -> Plan:
    """Route and grid of one launch.  On the ``"wgmma"`` route a CTA
    takes ``WGMMA_ROWS // group`` queries times the group's heads (126 or
    120 rows at group 9 or 12) against every key tile of
    ``WGMMA_TILE_K`` keys.  On the ``"decode"`` route a CTA takes every
    row of one (batch, KV head), ``DECODE_ROWS[0]`` or
    ``DECODE_ROWS[1]`` of them (the instantiation that holds Sq * group),
    and one run of ``tiles_per_split`` key tiles of
    :func:`decode_tile_keys` keys: the runs are cut so that the B * Hkv *
    n_split CTAs fill ``DECODE_CTAS_PER_SM`` on each of the card's
    ``n_sm`` SMs, each run at most ``DECODE_MAX_KEYS`` keys.  On the
    ``"cuda_cores"`` route a CTA takes ``ROWS_PER_CTA`` rows; the keys
    are split only when the query CTAs alone leave most SMs idle, so that
    about two CTAs for each SM read the K/V slots, each split at least
    ``MIN_TILES_PER_SPLIT`` tiles long."""
    group = H // Hkv
    how = route(dtype, Sq, H, Hkv, hd)
    if how == "wgmma":
        bq = WGMMA_ROWS // group
        return Plan("wgmma", bq * group, -(-Sq // bq) * B * Hkv, 1,
                    max(1, -(-Sk // WGMMA_TILE_K)))
    if how == "decode":
        rows = next(r for r in DECODE_ROWS if Sq * group <= r)
        ctas = B * Hkv
        tile = decode_tile_keys(hd, dtype)
        n_tiles = max(1, -(-Sk // tile))
        want = max(1, DECODE_CTAS_PER_SM * n_sm // ctas)
        per = min(-(-n_tiles // want), DECODE_MAX_KEYS // tile)
        return Plan("decode", rows, ctas, -(-n_tiles // per), per)
    ctas = -(-Sq // (ROWS_PER_CTA // group)) * B * Hkv
    n_tiles = max(1, -(-Sk // TILE_K))
    want = max(1, min(2 * n_sm // ctas, n_tiles // MIN_TILES_PER_SPLIT))
    per = -(-n_tiles // want)
    return Plan("cuda_cores", ROWS_PER_CTA, ctas, -(-n_tiles // per), per)


def launch(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
           q_pos: torch.Tensor, k_pos: torch.Tensor, causal: bool,
           window: Optional[int], softcap: Optional[float],
           scale: float) -> Tuple[torch.Tensor, str]:
    """One launch on the current stream of q's device; returns the output
    in q's shape and dtype, and the route it took."""
    B, Sq, H, hd = q.shape
    Sk, Hkv = k.shape[1], k.shape[2]
    how = plan(
        B, Sq, Sk, H, Hkv, hd, q.dtype,
        torch.cuda.get_device_properties(q.device).multi_processor_count)
    if how.route == "wgmma":
        return _launch_wgmma(q, k, v, q_pos, k_pos, causal, window, softcap,
                             scale, how.tiles_per_split), how.route
    route_, rows, ctas, n_split, per = how
    fn = _decode_entry() if route_ == "decode" else _entry()
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
            f"(route {route_}, B={B}, Sq={Sq}, Sk={Sk}, H={H}, Hkv={Hkv}, "
            f"hd={hd}, dtype={q.dtype}, n_split={n_split})")
    return out, route_


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

