"""Build and bind the CUDA flash-attention kernel
(``csrc/flash_attention.cu``).

The source has a plain C interface, so it is compiled with ``nvcc`` into
a shared library at the first launch (:mod:`repro_torch.kernels._build`)
and called through ``ctypes``: pointers and the stream go as
``c_void_p``, sizes and flags as ``c_int``, the softcap and the scale as
``c_float`` (kernel arguments: no device read, no host sync).
:func:`launch` assumes the checks of
:func:`repro_torch.kernels.flash_attention.ops.flash_attention` have
passed.
"""
from __future__ import annotations

import ctypes
import functools
import pathlib
from typing import Optional, Tuple

import torch

from .. import _build

SOURCE = (pathlib.Path(__file__).resolve().parent / "csrc"
          / "flash_attention.cu")
HEAD_DIMS = (64, 128, 256)       # the source's instantiations
DTYPES = {torch.float32: 0, torch.bfloat16: 1}
ROWS_PER_CTA = (8, 64)              # kWarps * RPW in the source, RPW 1 or 8
TILE_K = 32                         # kTileK in the source
MIN_TILES_PER_SPLIT = 8


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


def build() -> None:
    """Compile and load the library now (it is otherwise built at the
    first launch)."""
    _entry()


def plan(B: int, Sq: int, Sk: int, H: int, Hkv: int, n_sm: int
         ) -> Tuple[int, int, int, int]:
    """Grid of one launch: (query rows per CTA, CTAs over queries and KV
    heads, key splits, key tiles per split).  A CTA takes 8 rows (one a
    warp) when the call's Sq * group rows fit in 8 (a decode step), else
    64.  The keys are split only when the query CTAs alone leave most SMs
    idle (decode), so that about two CTAs for each of the card's
    ``n_sm`` SMs read the K/V slots, each split at least
    ``MIN_TILES_PER_SPLIT`` tiles long."""
    group = H // Hkv
    rows = ROWS_PER_CTA[0] if Sq * group <= ROWS_PER_CTA[0] \
        else ROWS_PER_CTA[1]
    ctas = -(-Sq // (rows // group)) * B * Hkv
    n_tiles = max(1, -(-Sk // TILE_K))
    want = max(1, min(2 * n_sm // ctas, n_tiles // MIN_TILES_PER_SPLIT))
    per = -(-n_tiles // want)
    return rows, ctas, -(-n_tiles // per), per


def launch(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
           q_pos: torch.Tensor, k_pos: torch.Tensor, causal: bool,
           window: Optional[int], softcap: Optional[float],
           scale: float) -> torch.Tensor:
    """One launch on the current stream of q's device; returns the output
    in q's shape and dtype."""
    B, Sq, H, hd = q.shape
    Sk, Hkv = k.shape[1], k.shape[2]
    rows, ctas, n_split, per = plan(
        B, Sq, Sk, H, Hkv,
        torch.cuda.get_device_properties(q.device).multi_processor_count)
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
    return out

