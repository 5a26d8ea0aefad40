"""repro_torch — the PyTorch/CUDA port of ``repro`` for NVIDIA Hopper.

A standalone package beside the JAX reference: it imports ``torch`` and
numpy, never JAX and nothing of ``repro``.  Module paths follow the
reference (``repro_torch.serve.mtl`` is the port of ``repro.serve.mtl``)
so each port module has an obvious counterpart to be tested against.

Every entry point runs on the CUDA card unless the caller passes
``device="cpu"`` (:func:`repro_torch._device.resolve_device`); there is
no silent CPU fallback.  Ported so far: the factored serving path (its
scoring kernel, :mod:`repro_torch.kernels.mtl_score`), the full-batch
solvers on the simulated cluster behind :func:`solve` (the raw-path
gradient kernel, :mod:`repro_torch.kernels.mtl_grad`), and their
stochastic rounds on the reference's own threefry draws
(:mod:`repro_torch.core.prng`, :mod:`repro_torch.data.synthetic`; the
fused local-step kernel, :mod:`repro_torch.kernels.prox_step`), the mesh
runtime on ``torch.distributed``, preemption-safe solves (``solve(...,
ckpt_dir=)`` and :func:`resume`, with the fault harness
:mod:`repro_torch.faults`), device round metrics (``metrics=True``), the
streaming re-solver (:mod:`repro_torch.train.streaming`) and the LM
serving paths.  The kernels are written by hand in CUDA C++ for
``sm_90a``.
"""
from ._device import resolve_device


def __getattr__(name):
    # lazy, so importing the serving path does not import the solvers
    if name == "solve":
        from .api import solve
        return solve
    if name == "resume":
        from .api import resume
        return resume
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")


__all__ = ["resolve_device", "resume", "solve"]
