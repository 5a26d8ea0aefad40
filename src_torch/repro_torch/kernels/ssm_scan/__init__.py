"""The Mamba-1 selective scan with an optional carried state — every SSM
scan of the falcon-mamba serving path: the cache-free forward, prefill
and each decode step — bare (:func:`selective_scan`) and with the Mamba
mixer's softplus, D skip and SiLU gate fused in (:func:`mamba_scan`)."""
from .ops import mamba_scan, selective_scan
from .ref import mamba_scan_ref, selective_scan_ref

__all__ = ["mamba_scan", "mamba_scan_ref", "selective_scan",
           "selective_scan_ref"]
