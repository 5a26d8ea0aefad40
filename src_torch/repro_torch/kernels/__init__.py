"""Hand-written Hopper kernels, one package per reference Pallas kernel.

Each package keeps the reference layout: ``ref.py`` holds the plain
PyTorch version, ``kernel.py`` builds and binds the CUDA source under
``csrc/``, and ``ops.py`` dispatches — the plain version for tensors on
the CPU, the kernel for tensors on the card, never a fallback between
them.
"""
