"""Plain PyTorch scorer + quantized-code-table helpers.

Port of ``repro.kernels.mtl_score.ref``.  :func:`mtl_score_ref` is the
plain version of the CUDA kernel: the CPU path of
:func:`repro_torch.kernels.mtl_score.ops.mtl_score` and the oracle the
kernel is held against on the card.

Id contract: ids are CLAMPED to [0, m-1], the hand-written kernel's
contract and the reference Pallas kernel's (``kernel.py:47``).  (The
reference's own ``mtl_score_ref`` uses ``jnp.take``, which under
jax 0.9 fills NaN for id >= m and wraps negative ids; served scores
never see either, because the server rejects such batches.)

Quantization scheme: per-code symmetric scaling.  Each code row
``C[j] (r,)`` gets one f32 scale ``s_j = max|C[j]| / qmax`` (qmax 127
for int8, 448 for fp8 e4m3) and is stored as ``q_j = cast(C[j] / s_j)``;
dequantize is the single multiply ``q_j * s_j``.  Zero rows get scale
1.0 so quantize→dequantize is exact on them.  The arithmetic is the
reference's, so the tables are bitwise equal to its tables.
"""
from __future__ import annotations

from typing import Tuple

import torch

CODE_DTYPES = ("f32", "int8", "fp8")
_QMAX = {"int8": 127.0, "fp8": 448.0}      # float8_e4m3fn max normal


def quantize_codes(C, code_dtype: str = "f32"
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(m, r) float codes -> (Cq, S): the stored table + (m, 1) f32
    per-code scales with ``C ≈ Cq.float() * S``.

    ``code_dtype``: "f32" (identity, scales exactly 1.0 so the kernel's
    dequantize multiply is bitwise neutral), "int8", or "fp8"
    (``torch.float8_e4m3fn``).
    """
    C = torch.as_tensor(C).to(torch.float32)
    if code_dtype == "f32":
        return C.contiguous(), torch.ones((C.shape[0], 1), dtype=torch.float32,
                                          device=C.device)
    if code_dtype not in _QMAX:
        raise ValueError(f"code_dtype must be one of {CODE_DTYPES}, "
                         f"got {code_dtype!r}")
    amax = torch.amax(torch.abs(C), dim=1, keepdim=True)
    S = torch.where(amax > 0, amax / _QMAX[code_dtype], torch.ones_like(amax))
    scaled = C / S
    if code_dtype == "int8":
        q = torch.clamp(torch.round(scaled), -127.0, 127.0).to(torch.int8)
    else:
        q = scaled.to(torch.float8_e4m3fn)
    return q.contiguous(), S


def dequantize_codes(Cq: torch.Tensor, S: torch.Tensor) -> torch.Tensor:
    """Invert :func:`quantize_codes`: (m, r) f32 approximation."""
    return Cq.to(torch.float32) * S.to(torch.float32)


def _gather_rows(C: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``C[idx]`` for any table dtype.  One-byte tables (int8, fp8) are
    gathered through a ``uint8`` view: ``index_select`` on float8 is not
    implemented on every device."""
    if C.element_size() == 1:
        return C.view(torch.uint8).index_select(0, idx).view(C.dtype)
    return C.index_select(0, idx)


def mtl_score_ref(U: torch.Tensor, C: torch.Tensor, S: torch.Tensor,
                  ids: torch.Tensor, X: torch.Tensor) -> torch.Tensor:
    """Plain version: gemm → clamped gather → dequantize → reduce.

    U (p, r) f32/bf16; C (m, r) f32/int8/fp8; S (m, 1) f32; ids (B,)
    int; X (B, p) f32/bf16 → (B,) f32 scores, accumulated in f32.
    """
    z = X.to(torch.float32) @ U.to(torch.float32)
    idx = torch.clamp(ids.long(), 0, C.shape[0] - 1)
    codes = (_gather_rows(C, idx).to(torch.float32)
             * S.to(torch.float32).index_select(0, idx))
    return torch.sum(z * codes, dim=1)
