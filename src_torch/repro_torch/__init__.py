"""repro_torch — the PyTorch/CUDA port of ``repro`` for NVIDIA Hopper.

A standalone package beside the JAX reference: it imports ``torch`` and
numpy, never JAX and nothing of ``repro``.  Module paths follow the
reference (``repro_torch.serve.mtl`` is the port of ``repro.serve.mtl``)
so each port module has an obvious counterpart to be tested against.

Every entry point runs on the CUDA card unless the caller passes
``device="cpu"`` (:func:`repro_torch._device.resolve_device`); there is
no silent CPU fallback.  The serving path's scoring kernel is written by
hand in CUDA C++ for ``sm_90a`` (:mod:`repro_torch.kernels.mtl_score`).
"""
from ._device import resolve_device

__all__ = ["resolve_device"]
