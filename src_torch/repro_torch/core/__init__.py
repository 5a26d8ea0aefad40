"""The paper's math, ported piece by piece: losses, per-task linear
models and the one-shot spectral truncation."""
