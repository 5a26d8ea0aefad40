"""Synthetic LM token pipeline for the model-zoo training path.

Port of ``repro.data.tokens``, copied: pure numpy, so a seed gives the
same batches bit for bit in both packages.

Offline container: no real corpora. We synthesize token streams from a
mixture of Zipfian unigrams and short repeated n-gram "motifs" so the
loss actually decreases during the end-to-end example (a pure-uniform
stream would pin the loss at log V). The pipeline yields sharded
(tokens, targets) batches and is deliberately shaped like a production
loader: deterministic per-step RNG, epoch-free infinite stream, host
batching then device put.
"""
from __future__ import annotations

import dataclasses
from typing import Iterator, Tuple

import numpy as np


@dataclasses.dataclass(frozen=True)
class TokenPipelineSpec:
    vocab_size: int
    seq_len: int
    global_batch: int
    seed: int = 0
    zipf_a: float = 1.2
    n_motifs: int = 64
    motif_len: int = 8
    motif_prob: float = 0.35


class SyntheticTokenStream:
    def __init__(self, spec: TokenPipelineSpec):
        self.spec = spec
        rng = np.random.default_rng(spec.seed)
        v = spec.vocab_size
        # Zipf over a capped support for speed, rest of vocab unused tail.
        support = min(v, 32768)
        ranks = np.arange(1, support + 1, dtype=np.float64)
        probs = ranks ** (-spec.zipf_a)
        self._probs = probs / probs.sum()
        self._support = support
        self._motifs = rng.integers(0, support,
                                    size=(spec.n_motifs, spec.motif_len))

    def batch(self, step: int) -> Tuple[np.ndarray, np.ndarray]:
        """(tokens, targets) each (global_batch, seq_len) int32."""
        s = self.spec
        rng = np.random.default_rng((s.seed, step))
        total = s.global_batch * (s.seq_len + 1)
        toks = rng.choice(self._support, size=total, p=self._probs)
        toks = toks.reshape(s.global_batch, s.seq_len + 1)
        # plant motifs: predictable continuations for learnability
        n_plant = int(s.motif_prob * s.global_batch * s.seq_len
                      / s.motif_len)
        if n_plant:
            rows = rng.integers(0, s.global_batch, n_plant)
            cols = rng.integers(0, s.seq_len + 1 - s.motif_len, n_plant)
            which = rng.integers(0, s.n_motifs, n_plant)
            for rr, cc, ww in zip(rows, cols, which):
                toks[rr, cc:cc + s.motif_len] = self._motifs[ww]
        toks = toks.astype(np.int32)
        return toks[:, :-1], toks[:, 1:]

    def __iter__(self) -> Iterator[Tuple[np.ndarray, np.ndarray]]:
        step = 0
        while True:
            yield self.batch(step)
            step += 1
