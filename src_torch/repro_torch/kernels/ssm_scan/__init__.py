"""The Mamba-1 selective scan with an optional carried state — every SSM
scan of the falcon-mamba serving path: the cache-free forward, prefill
and each decode step."""
from .ops import selective_scan
from .ref import selective_scan_ref

__all__ = ["selective_scan", "selective_scan_ref"]
