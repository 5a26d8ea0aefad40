"""Batched serving engine: prefill plus greedy or temperature decode over
a fixed-size request batch with a shared KV cache.

Port of ``repro.serve.engine``: fixed batch slots, waves of
``batch_size`` requests, left padding to the wave's longest prompt,
per-slot positions, EOS retirement and ``max_new_tokens`` bookkeeping as
the reference keeps them.  The decode loop reads the sampled tokens back
once per step (the bookkeeping needs them on the host); everything else
stays on the model's device.  Every attention call of the prefill and of
each decode step goes through
:func:`repro_torch.kernels.flash_attention.flash_attention`, and every SSM
scan of a Mamba model's prefill and decode steps through
:func:`repro_torch.kernels.ssm_scan.mamba_scan`, from the state that
:func:`~repro_torch.models.model.init_cache` sets to zero (prefill) or
that the last step left (decode).  Sampling is
the reference's: greedy ``argmax`` (first index on ties), or a
``split`` of the engine's threefry key and
:func:`repro_torch.core.prng.categorical` on ``logits / temperature``,
the same keys and Gumbel bits as ``jax.random``.
"""
from __future__ import annotations

import dataclasses
from typing import List

import numpy as np
import torch

from .._device import DeviceLike, resolve_device
from ..configs.base import ModelConfig
from ..core import prng
from ..models import model as model_mod


@dataclasses.dataclass
class Request:
    prompt: np.ndarray                  # (S,) int32
    max_new_tokens: int = 32
    eos_id: int = -1                    # -1: never stops early
    out_tokens: List[int] = dataclasses.field(default_factory=list)
    done: bool = False


class ServeEngine:
    """Serve :class:`Request`\\ s in waves of ``batch_size`` with the model
    ``model`` (a :class:`~repro_torch.models.model.LM` on ``device``,
    default the card)."""

    def __init__(self, model: model_mod.LM, cfg: ModelConfig, *,
                 batch_size: int, max_len: int, temperature: float = 0.0,
                 seed: int = 0, device: DeviceLike = None):
        dev = resolve_device(device)
        if model.device.type != dev.type or dev.index not in (
                None, model.device.index):
            raise ValueError(f"the model lies on {model.device}, the engine "
                             f"serves on {dev}")
        self.device = model.device
        self.model, self.cfg = model, cfg
        self.B, self.max_len = batch_size, max_len
        self.temperature = temperature
        self.key = prng.PRNGKey(seed, device=self.device)

    def generate(self, requests: List[Request]) -> List[Request]:
        """Run requests through in waves of B (synchronous batching)."""
        pending = list(requests)
        while pending:
            wave, pending = pending[:self.B], pending[self.B:]
            self._run_wave(wave)
        return requests

    def _run_wave(self, wave: List[Request]) -> None:
        B, dev = self.B, self.device
        S = max(len(r.prompt) for r in wave)
        toks = np.zeros((B, S), np.int64)
        for i, r in enumerate(wave):
            toks[i, S - len(r.prompt):] = r.prompt   # left-pad
        cache = model_mod.init_cache(self.cfg, B, self.max_len, dev)
        batch = {"tokens": torch.from_numpy(toks).to(dev)}
        logits, cache = model_mod.prefill(self.model, batch, cache)

        pos = torch.full((B,), S, dtype=torch.int32, device=dev)
        max_new = max(r.max_new_tokens for r in wave)
        live = np.array([not r.done for r in wave] + [False] * (B - len(wave)))
        cur = self._sample(logits)
        cur_host = cur.cpu().numpy()
        for i, r in enumerate(wave):
            if live[i]:
                r.out_tokens.append(int(cur_host[i]))
        for _ in range(max_new - 1):
            if not live.any():
                break
            logits, cache = model_mod.decode_step(self.model, cur, pos, cache)
            pos = pos + 1
            cur = self._sample(logits)
            cur_host = cur.cpu().numpy()            # the step's one sync
            for i, r in enumerate(wave):
                if not live[i]:
                    continue
                t = int(cur_host[i])
                r.out_tokens.append(t)
                if t == r.eos_id or len(r.out_tokens) >= r.max_new_tokens:
                    r.done = True
                    live[i] = False
        for r in wave:
            r.done = True

    def _sample(self, logits: torch.Tensor) -> torch.Tensor:
        """Next tokens (B,) int64 on the device."""
        if self.temperature <= 0:
            return torch.argmax(logits, dim=-1)
        keys = prng.split(self.key)
        self.key, sub = keys[0], keys[1]
        return prng.categorical(sub, logits / self.temperature)
