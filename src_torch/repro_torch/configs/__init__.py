"""Config registry of the port: the dense, non-MoE, non-MLA language
models and the Mamba-1 model, which run through exactly the port's LM
modules.

The reference registers ten architectures (``repro.configs``); the port
registers the five whose serving path it has ported.  Asking for any of
the other five raises :class:`NotImplementedError` naming the ROADMAP item
that brings it.
"""
from __future__ import annotations

from . import (falcon_mamba_7b, gemma2_2b, gemma_7b, starcoder2_3b,
               starcoder2_7b)
from .base import INPUT_SHAPES, InputShape, ModelConfig

_MODULES = {
    "falcon-mamba-7b": falcon_mamba_7b,
    "gemma2-2b": gemma2_2b,
    "gemma-7b": gemma_7b,
    "starcoder2-3b": starcoder2_3b,
    "starcoder2-7b": starcoder2_7b,
}

# the reference's other architectures, and the ROADMAP item that ports
# the modules each one needs
_NOT_PORTED = {
    "zamba2-7b": "Queue 1 item 11c (hybrid: mamba-2 and the shared "
                 "attention block)",
    "granite-moe-3b-a800m": "Queue 1 item 11c (MoE layers)",
    "deepseek-v3-671b": "Queue 1 item 11c (MLA, MoE and MTP)",
    "whisper-large-v3": "Queue 1 item 11c (encoder-decoder, "
                        "cross-attention)",
    "paligemma-3b": "Queue 1 item 11c (VLM prefix, prefix-LM masks)",
}

ARCH_IDS = sorted(_MODULES)


def _module(arch_id: str):
    if arch_id in _MODULES:
        return _MODULES[arch_id]
    if arch_id in _NOT_PORTED:
        raise NotImplementedError(
            f"{arch_id} is not ported yet: ROADMAP {_NOT_PORTED[arch_id]}")
    raise KeyError(f"unknown arch {arch_id!r}; the port has {ARCH_IDS}")


def get_config(arch_id: str, *, shape: str | None = None) -> ModelConfig:
    """Full config; for long_500k gemma2 swaps in its documented
    all-local variant, as the reference does."""
    mod = _module(arch_id)
    if shape == "long_500k" and hasattr(mod, "long_context"):
        return mod.long_context()
    return mod.FULL


def get_smoke_config(arch_id: str) -> ModelConfig:
    return _module(arch_id).smoke()


__all__ = ["ARCH_IDS", "INPUT_SHAPES", "InputShape", "ModelConfig",
           "get_config", "get_smoke_config"]
