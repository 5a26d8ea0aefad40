"""Common API for the paper's multi-task solvers.

Port of ``repro.core.methods.base``.  A problem instance bundles the
per-task datasets (stacked over the task axis — the "machines") plus the
structural constants of Assumption 2.1 / 2.3, on one device.  Every
solver returns an :class:`MTLResult` carrying the final predictor
matrix, the per-round iterates (for the excess-error-vs-communication
plots of Figs 1-3), and the communication ledger.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict, List, Optional

import numpy as np
import torch

from ..._device import DeviceLike, resolve_device
from ..comm import CommLog
from ..losses import Loss, get_loss

@dataclasses.dataclass
class MTLProblem:
    Xs: torch.Tensor           # (m, n, p) per-machine designs
    ys: torch.Tensor           # (m, n)    per-machine labels
    loss: Loss
    A: float = 1.0             # predictor-norm bound, Assumption 2.1
    r: int = 5                 # assumed rank bound, Assumption 2.3
    l2: float = 0.0            # optional ridge (real-data experiments, App. H)
    # Cached per-task Gram statistics A_j = X_j^T X_j / n (m, p, p) and
    # b_j = X_j^T y_j / n (m, p), built once in `make` for the squared
    # loss on the problem's device (repro_torch.core.worker_ops).
    gram_A: Optional[torch.Tensor] = None
    gram_b: Optional[torch.Tensor] = None

    @property
    def m(self) -> int:
        return self.Xs.shape[0]

    @property
    def n(self) -> int:
        return self.Xs.shape[1]

    @property
    def p(self) -> int:
        return self.Xs.shape[2]

    @property
    def device(self) -> torch.device:
        return self.Xs.device

    @property
    def nuclear_radius(self) -> float:
        # ||W*||_* <= sqrt(r m) A, eq. (2.2), in f32 as the reference
        return float(np.sqrt(np.float32(self.r * self.m)) * np.float32(self.A))

    def worker_data(self) -> Dict[str, torch.Tensor]:
        """The per-task data leaves the runtime binds into round bodies,
        each stacked over the task axis; ``task_ids`` is each task's
        global index."""
        d = {"Xs": self.Xs, "ys": self.ys,
             "task_ids": torch.arange(self.m, dtype=torch.int32,
                                      device=self.device)}
        if self.gram_A is not None:
            d["gram_A"], d["gram_b"] = self.gram_A, self.gram_b
        return d

    @classmethod
    def make(cls, Xs, ys, loss_name: str = "squared", gram: bool = True,
             device: DeviceLike = None, **kw) -> "MTLProblem":
        """Build a problem from stacked per-task data on ``device``
        (default: the card; raises without one).

        ``gram=True`` (default) precomputes the per-task Gram cache for
        the squared loss on that device, making every solver round
        O(p²) per task independent of n; ``gram=False`` keeps the
        raw-data path, whose gradients go through the ``mtl_grad``
        kernel on the card.  float64 data becomes float32, as the
        reference's ``jnp.asarray`` makes it without x64."""
        dev = resolve_device(device)
        Xs, ys = (torch.as_tensor(a, device=dev) for a in (Xs, ys))
        Xs, ys = (a.float() if a.dtype == torch.float64 else a
                  for a in (Xs, ys))
        loss = get_loss(loss_name)
        prob = cls(Xs=Xs, ys=ys, loss=loss, **kw)
        if gram and loss.name == "squared":
            from ..worker_ops import gram_stats
            prob.gram_A, prob.gram_b = gram_stats(Xs, ys)
        return prob


@dataclasses.dataclass
class MTLResult:
    name: str
    W: torch.Tensor                    # (p, m) final predictors
    comm: CommLog
    # iterates[k] = W after round rounds_axis[k]; one-shot methods have a
    # single entry at round 0 (Local) or 1 (Centralize / SVD-trunc).
    iterates: List[torch.Tensor] = dataclasses.field(default_factory=list)
    rounds_axis: List[int] = dataclasses.field(default_factory=list)
    extras: Dict = dataclasses.field(default_factory=dict)

    def record(self, rnd: int, W: torch.Tensor) -> None:
        self.rounds_axis.append(rnd)
        self.iterates.append(W)

    def factorize(self, rank: int, loss: Optional[str] = None,
                  task_keys=None, device: DeviceLike = None):
        """The factored serving artifact ``(U, s, V)`` at the given rank:
        :meth:`repro_torch.serve.mtl.FactoredModel.from_W` on ``device``
        (default: where ``W`` lies, so a solve on the card serves on the
        card).  ``loss`` defaults to the loss the front door stamped
        into ``extras`` ("squared" for results built outside it)."""
        from ...serve.mtl import FactoredModel
        if loss is None:
            loss = self.extras.get("loss", "squared")
        return FactoredModel.from_W(
            self.W, rank, loss=loss, task_keys=task_keys,
            device=self.W.device if device is None else device)


# Registry names of the gradient-served solvers that accept the
# stochastic worker path in the reference.
STOCHASTIC_SOLVERS = ("accproxgd", "admm", "dgsp", "dnsp", "proxgd")


def stochastic_config(prob: MTLProblem, batch_size, local_steps,
                      data_shards: int = 1):
    """Normalize a solver's ``(batch_size, local_steps)`` pair.

    Returns ``(B, L)`` for a genuinely stochastic configuration, or
    ``None`` when the solver must run its EXACT full-batch program
    (``batch_size == n`` and ``local_steps == 1`` IS the full-batch
    algorithm).  Validation is the reference's.
    """
    if batch_size is None and local_steps in (None, 1):
        return None
    B = prob.n if batch_size is None else int(batch_size)
    L = 1 if local_steps is None else int(local_steps)
    if not 1 <= B <= prob.n:
        raise ValueError(f"batch_size={B} outside [1, n={prob.n}]")
    if L < 1:
        raise ValueError(f"local_steps={L} must be >= 1")
    if B % data_shards:
        raise ValueError(f"batch_size={B} must be divisible by "
                         f"data_shards={data_shards} (each shard samples "
                         f"batch_size/data_shards of its local rows)")
    if B == prob.n and L == 1:
        return None
    return B, L


def stamp_sgd(res: MTLResult, sgd) -> None:
    """Record a stochastic configuration's ``(B, L)`` in ``res.extras``."""
    if sgd is not None:
        res.extras.update(batch_size=sgd[0], local_steps=sgd[1])


def stochastic_round_leaves(prob: MTLProblem):
    """Data leaves a stochastic round body reads (the reference's list)."""
    return ("Xs", "ys", "task_ids")


def gram_round_leaves(prob: MTLProblem):
    """Data leaves a round body reads when the Gram cache serves every
    worker path (squared loss, cache built); ``None`` (= bind everything)
    otherwise."""
    if prob.loss.name == "squared" and prob.gram_A is not None:
        return ("gram_A", "gram_b")
    return None


def iterate_recorder(res: "MTLResult", record_every: int, key: str = "W"):
    """RecordSpec snapshotting one state leaf into the result every
    ``record_every`` rounds (and always the final round)."""
    from ...runtime.base import RecordSpec
    return RecordSpec(sink=res, every=record_every, key=key)


def metrics_channel(metrics: bool, prob: MTLProblem):
    """The device round-metrics channel (:mod:`repro_torch.obs.device`):
    ``(initial obs entry, RecordSpec, sink)`` when ``metrics`` is on,
    else ``None``.

    The solver adds the entry to its round-loop state (replicated: it
    never enters ``sharded``), updates it in the body with ``obs_round``
    from master-visible quantities only (no new collective, the same
    ledger), passes the RecordSpec beside its iterate recorder, and
    stamps ``sink.finalize(rt)`` into ``extras["metrics"]``.
    """
    if not metrics:
        return None
    from ...obs.device import OBS_KEY, RoundMetricsSink, obs_init
    from ...runtime.base import RecordSpec
    sink = RoundMetricsSink()
    return (obs_init(prob.device), RecordSpec(sink=sink, every=1,
                                              key=OBS_KEY), sink)


def compose_records(base, channel):
    """``run_rounds(record=...)`` from the iterate recorder plus an
    optional metrics channel."""
    return base if channel is None else (base, channel[1])


def default_runtime(prob: MTLProblem, runtime=None):
    """The runtime a solver executes on; defaults to the simulated cluster."""
    if runtime is not None:
        return runtime
    from ...runtime.sim import SimRuntime
    return SimRuntime(prob)


SolverFn = Callable[..., MTLResult]
_REGISTRY: Dict[str, SolverFn] = {}


def register(name: str):
    def deco(fn: SolverFn) -> SolverFn:
        _REGISTRY[name] = fn
        fn.solver_name = name
        return fn
    return deco


def get_solver(name: str) -> SolverFn:
    try:
        return _REGISTRY[name]
    except KeyError:
        raise ValueError(f"unknown solver {name!r}; have {sorted(_REGISTRY)}")


def solver_names() -> List[str]:
    return sorted(_REGISTRY)
