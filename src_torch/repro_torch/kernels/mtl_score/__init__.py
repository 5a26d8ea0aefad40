"""Fused factored-model scoring kernel + quantized code tables."""
from .ops import mtl_score
from .ref import (CODE_DTYPES, dequantize_codes, mtl_score_ref,
                  quantize_codes)

__all__ = ["mtl_score", "mtl_score_ref", "quantize_codes",
           "dequantize_codes", "CODE_DTYPES"]
