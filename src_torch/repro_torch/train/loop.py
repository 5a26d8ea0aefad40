"""Host-side training loop, port of ``repro.train.loop``: data feed, the
step, metrics, checkpoints, resume.

The train state (``{"model", "opt"}``, :func:`repro_torch.train.steps.
init_train_state`) is checkpointed as the reference's ``{"params",
"opt": {"mu", "nu", "count"}}`` in the reference's layout
(:func:`repro_torch.interop.train_state_tree`) and restored into the
state in place.
"""
from __future__ import annotations

import time
import warnings
from typing import Callable, Dict, Iterable, Optional

import torch

from ..interop import load_train_state, train_state_tree
from .checkpoint import (available_steps, load_latest_intact,
                         save_checkpoint)


def train_loop(train_step: Callable, state, batches: Iterable,
               n_steps: int, *, log_every: int = 10,
               ckpt_dir: Optional[str] = None, ckpt_every: int = 500,
               resume: bool = True,
               log_fn: Callable[[str], None] = print) -> Dict:
    """Run ``n_steps`` of ``train_step`` with periodic checkpoints.

    Preemption recovery, as the reference's: when ``ckpt_dir`` already
    holds checkpoints and ``resume=True`` (the default), the loop
    restarts from the newest INTACT one (corrupt or truncated files are
    skipped with a warning) and fast-forwards the batch iterator past
    the consumed batches, so the resumed run sees the stream a
    never-killed run would have seen.  ``resume=False`` forces a fresh
    start.  Batches are dicts or ``(tokens, targets)`` pairs; numpy
    arrays become CPU tensors (the step moves them to its device).
    Metrics are read back only on the steps that are logged.
    """
    history = {"step": [], "loss": [], "nll": []}
    it = iter(batches)
    start_step = 0
    if ckpt_dir and resume and available_steps(ckpt_dir):
        ckpt_step, ckpt_state, skipped = load_latest_intact(ckpt_dir)
        if skipped:
            warnings.warn(f"train_loop resume skipped corrupt "
                          f"checkpoint steps {skipped} in {ckpt_dir}")
        if ckpt_step >= n_steps:
            log_fn(f"resume: {ckpt_dir} already holds step {ckpt_step} "
                   f">= n_steps={n_steps}; nothing to do")
            return history
        state = load_train_state(state, ckpt_state)
        start_step = ckpt_step
        for _ in range(start_step):       # fast-forward the batch stream
            next(it)
        log_fn(f"resume: restarting from checkpoint step {start_step} "
               f"in {ckpt_dir}")
    t0 = time.time()
    done = 0
    for step in range(start_step, n_steps):
        batch = next(it)
        if isinstance(batch, tuple):          # (tokens, targets) pipelines
            batch = {"tokens": batch[0], "targets": batch[1]}
        batch = {k: torch.as_tensor(v) for k, v in batch.items()}
        state, metrics = train_step(state, batch)
        done += 1
        if (step + 1) % log_every == 0 or step == start_step:
            loss = float(metrics["loss"])
            nll = float(metrics.get("nll", metrics["loss"]))
            dt = time.time() - t0
            log_fn(f"step {step + 1:5d}  loss {loss:.4f}  nll {nll:.4f}  "
                   f"({dt / done:.2f}s/step)")
            history["step"].append(step + 1)
            history["loss"].append(loss)
            history["nll"].append(nll)
        if ckpt_dir and (step + 1) % ckpt_every == 0:
            save_checkpoint(ckpt_dir, step + 1, train_state_tree(state))
    if ckpt_dir:
        save_checkpoint(ckpt_dir, n_steps, train_state_tree(state))
    return history
