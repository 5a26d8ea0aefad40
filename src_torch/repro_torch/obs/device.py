"""Device-resident round metrics: the ``"obs"`` state entry.

Port of ``repro.obs.device``.  A solver called with ``metrics=True``
adds one replicated entry to its round-loop state, a dict of scalar
tensors updated by the round body and snapshotted every round through
the same :class:`~repro_torch.runtime.base.RecordSpec` machinery that
snapshots ``W``.  The rules that keep it free of observable side effects
(DESIGN.md §15):

* **On the device until the end.**  Every field is a tensor on the
  solve's device; the snapshots stay there and are read back to the
  host once, in :meth:`RoundMetricsSink.finalize`, not once a round.
* **No new collectives.**  Every field comes from quantities the
  replicated master already holds (the gathered gradient matrix, the
  replicated iterate, the spectral engine's carry), so the CommLog
  template is unchanged.  The objective field is the master-visible
  regularizer term ``lam * ||W||_*`` (the shrink returns that nuclear
  norm anyway); solvers without a shrink report 0.
* **No W dataflow changes.**  The metric ops read round outputs and feed
  only the obs entry, so ``metrics=True`` leaves ``W`` and the ledger
  bit-identical to ``metrics=False``.

Fields (replicated scalars):

====================  =====================================================
``objective``         master-visible objective term (``lam * ||W||_*``
                      where the solver shrinks; 0.0 otherwise)
``grad_norm``         Frobenius norm of the gathered gradient/message
                      matrix entering the master step (0.0 when the
                      round has no full-batch gradient)
``step_norm``         Frobenius norm of the master-iterate change this
                      round
``sv_exact``          cumulative exact-SVD fallback rounds of the
                      spectral engine (0 for exact mode / no engine)
====================  =====================================================

The per-round charged communication is host state (the ledger
template), so the sink stamps ``charged_floats_per_round`` from the
runtime's template when it finalizes.
"""
from __future__ import annotations

from typing import Any, Dict, List, Optional

import numpy as np
import torch

__all__ = ["OBS_KEY", "FIELDS", "obs_init", "obs_round",
           "RoundMetricsSink"]

OBS_KEY = "obs"

FIELDS = ("objective", "grad_norm", "step_norm", "sv_exact")


def _fro(a: torch.Tensor) -> torch.Tensor:
    return torch.sqrt(torch.sum(torch.square(a.to(torch.float32))))


def obs_init(device=None) -> Dict[str, torch.Tensor]:
    """The round-0 obs entry: all-zero scalars on ``device``."""
    return {"objective": torch.zeros((), dtype=torch.float32, device=device),
            "grad_norm": torch.zeros((), dtype=torch.float32, device=device),
            "step_norm": torch.zeros((), dtype=torch.float32, device=device),
            "sv_exact": torch.zeros((), dtype=torch.int32, device=device)}


def obs_round(prev: torch.Tensor, new: torch.Tensor, *,
              grad: Optional[torch.Tensor] = None, objective=None,
              sv_stats: Optional[Dict[str, torch.Tensor]] = None
              ) -> Dict[str, torch.Tensor]:
    """One round's metrics from master-visible quantities only.

    ``prev``/``new`` are the replicated master iterate before and after
    the round; ``grad`` the gathered gradient/message matrix (None when
    the round has none); ``objective`` the master-visible objective
    term; ``sv_stats`` the spectral engine's counters
    (:meth:`ShrinkEngine.device_stats`).
    """
    dev = new.device
    zero = torch.zeros((), dtype=torch.float32, device=dev)
    return {
        "objective": zero if objective is None else
        torch.as_tensor(objective, device=dev).to(torch.float32),
        "grad_norm": zero if grad is None else _fro(grad),
        "step_norm": _fro(new - prev),
        "sv_exact": (torch.zeros((), dtype=torch.int32, device=dev)
                     if sv_stats is None
                     else sv_stats["sv_exact"].to(torch.int32)),
    }


class RoundMetricsSink:
    """Collects the per-round obs snapshots a RecordSpec delivers and
    finalizes them into ``MTLResult.extras["metrics"]``."""

    def __init__(self):
        self._rounds: List[int] = []
        self._values: List[Dict[str, Any]] = []

    def record(self, rnd: int, value: Dict[str, Any]) -> None:
        self._rounds.append(int(rnd))
        self._values.append(value)

    def finalize(self, rt=None) -> Dict[str, Any]:
        """Host arrays keyed by field, stacked over the recorded rounds
        (one read-back a field), plus the ledger's per-round charged
        floats from the runtime's communication template."""
        out: Dict[str, Any] = {"round": np.asarray(self._rounds, np.int64)}
        if self._values:
            for k in self._values[0]:
                out[k] = torch.stack([v[k] for v in self._values]) \
                    .cpu().numpy()
        else:
            for k in FIELDS:
                out[k] = np.zeros((0,), np.float32)
        if rt is not None:
            out["charged_floats_per_round"] = int(sum(
                ev.vectors * ev.dim for ev in rt._template))
        return out
