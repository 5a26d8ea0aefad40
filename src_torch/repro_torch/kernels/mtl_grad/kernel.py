"""Build and bind the CUDA gradient accumulator (``csrc/mtl_grad.cu``), and
plan its launch.

The source has a plain C interface, so it is compiled with ``nvcc`` into
a shared library at the first launch (:mod:`repro_torch.kernels._build`)
and called through ``ctypes``: pointers and the stream go as
``c_void_p``, sizes as ``c_int``.  The same library holds the fused prox
step's entry point (:mod:`repro_torch.kernels.prox_step.kernel` binds
it), so the source builds once for both.

:func:`plan` decides how a launch cuts its work: how many CTAs of a
thread-block cluster share a task's rows (``split``), the rows of one
staged tile and the stages of the ring; :func:`smem_bytes` and
:func:`row_ranges` are the kernel's own layout and row split, written
out so that the CPU tests can check them.  :func:`launch` assumes the
checks of :func:`repro_torch.kernels.mtl_grad.ops.task_gradients` have
passed.
"""
from __future__ import annotations

import ctypes
import functools
import pathlib
from typing import NamedTuple

import torch

from .. import _build

SOURCE = pathlib.Path(__file__).resolve().parent / "csrc" / "mtl_grad.cu"
LIBRARY = "mtl_grad"        # one library: mtl_grad_launch, prox_step_launch
MAX_P = 16384               # kMaxP in the source
MAX_SMEM = 227 * 1024       # kMaxSmem
MAX_TILE_ROWS = 256         # kMaxTileRows
SPLITS = (1, 2, 4, 8)       # cluster sizes the launch takes
STAGE_BYTES = 32 * 1024     # a tile of X, the unit of one TMA copy
STAGES = 2                  # the ring: two tiles a CTA
CTAS_PER_SM = 2             # the card is full with two CTAs on every SM
FILL = 0.9                  # m * split this share of those slots is "full"

X_DTYPES = {torch.float32: 0, torch.bfloat16: 1}
LOSS_CODES = {"squared": 0, "logistic": 1}


class Plan(NamedTuple):
    split: int          # CTAs per task (one cluster), rank k a row range
    tile_rows: int      # rows of one staged tile
    stages: int         # tiles in flight
    ctas: int           # m * split
    smem_bytes: int     # dynamic shared memory a CTA


def smem_bytes(p: int, tile_rows: int, stages: int, x_bytes: int) -> int:
    """A CTA's shared memory (``Layout`` in the source): w and the f32
    partial (p each, padded to 4), the residuals of each stage, two
    mbarriers a stage, then from a 128-byte bound the ring of stages, each
    a tile of X and its y, both widened by up to 30 bytes to 16-byte
    bounds."""
    p4 = (p + 3) & ~3
    r4 = (tile_rows + 3) & ~3
    stage = (((tile_rows * p * x_bytes + 15) & ~15) + 32
             + ((tile_rows * 4 + 15) & ~15) + 32)
    ring = (8 * p4 + 4 * stages * r4 + 16 * stages + 127) & ~127
    return ring + stages * stage


def row_ranges(n: int, tile_rows: int, split: int) -> list[tuple[int, int]]:
    """The rows [start, end) of each rank of a task's cluster, as the
    kernel cuts them: of the ceil(n / tile_rows) tiles, rank k takes
    tiles [k T / S, (k + 1) T / S)."""
    tiles = -(-n // tile_rows)
    return [(min(n, (k * tiles // split) * tile_rows),
             min(n, ((k + 1) * tiles // split) * tile_rows))
            for k in range(split)]


@functools.cache                # a solver launches the same shape each round
def plan(m: int, n: int, p: int, x_bytes: int, n_sm: int) -> Plan:
    """The launch for X (m, n, p) of ``x_bytes`` an element on a card of
    ``n_sm`` SMs.

    A tile is the rows that fit ``STAGE_BYTES`` (at least one, at most
    ``MAX_TILE_ROWS`` and n), cut to a multiple of 32 where it holds more
    (so that each of the 8 consumer warps sums whole groups of 4 rows);
    the ring has ``STAGES`` of them, fewer if shared memory is short (wide
    rows).  ``split`` is the smallest of
    ``SPLITS`` for which m * split CTAs come close to filling the card
    (``FILL`` of ``CTAS_PER_SM`` CTAs on each SM: one CTA's 8 consumer
    warps cannot keep up with the memory alone, two can), among those
    that leave each CTA at least two tiles; past the rows, the largest
    that does.
    """
    row = p * x_bytes
    tile_rows = max(1, min(STAGE_BYTES // row, MAX_TILE_ROWS, n))
    if tile_rows > 32:
        tile_rows -= tile_rows % 32
    stages = STAGES
    while stages > 1 and smem_bytes(p, tile_rows, stages, x_bytes) > MAX_SMEM:
        stages -= 1
    tiles = -(-n // tile_rows)
    ok = [s for s in SPLITS if s == 1 or tiles >= 2 * s]
    split = next((s for s in ok if m * s >= FILL * CTAS_PER_SM * n_sm),
                 ok[-1])
    return Plan(split, tile_rows, stages, m * split,
                smem_bytes(p, tile_rows, stages, x_bytes))


@functools.cache
def sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def plan_for(X: torch.Tensor) -> Plan:
    """:func:`plan` for X on its card."""
    m, n, p = X.shape
    return plan(m, n, p, X.element_size(), sm_count(X.device.index or 0))


@functools.cache
def library():
    return _build.load(LIBRARY, SOURCE)


@functools.cache
def _entry():
    fn = library().mtl_grad_launch
    fn.argtypes = [ctypes.c_void_p, ctypes.c_int,        # X, x_dtype
                   ctypes.c_void_p, ctypes.c_void_p,     # y, W
                   ctypes.c_void_p,                      # G
                   ctypes.c_int, ctypes.c_int,           # m, n
                   ctypes.c_int, ctypes.c_int,           # p, loss
                   ctypes.c_int, ctypes.c_int,           # split, tile_rows
                   ctypes.c_int,                         # stages
                   ctypes.c_void_p]                      # stream
    fn.restype = ctypes.c_int
    return fn


def build() -> None:
    """Compile and load the library now (it is otherwise built at the
    first launch)."""
    _entry()


def launch(X: torch.Tensor, y: torch.Tensor, W: torch.Tensor, loss: str,
           plan: Plan | None = None) -> torch.Tensor:
    """One launch on the current stream of X's device; returns (m, p) f32.
    ``plan`` defaults to :func:`plan_for`; a check may force another."""
    m, n, p = X.shape
    fn = _entry()
    pl = plan or plan_for(X)
    with torch.cuda.device(X.device):
        G = torch.empty((m, p), dtype=torch.float32, device=X.device)
        err = fn(X.data_ptr(), X_DTYPES[X.dtype], y.data_ptr(), W.data_ptr(),
                 G.data_ptr(), m, n, p, LOSS_CODES[loss], pl.split,
                 pl.tile_rows, pl.stages,
                 torch.cuda.current_stream().cuda_stream)
    if err != 0:
        raise RuntimeError(f"mtl_grad kernel launch failed with CUDA error "
                           f"{err} (m={m}, n={n}, p={p}, loss={loss}, {pl})")
    return G
