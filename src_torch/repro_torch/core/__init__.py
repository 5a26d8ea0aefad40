"""The paper's math, ported piece by piece: losses, per-task linear
models, the communication ledger, the worker ops, the spectral master,
the threefry generator (:mod:`repro_torch.core.prng`) and the solver
registry (:mod:`repro_torch.core.methods`)."""
