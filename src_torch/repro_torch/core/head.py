"""MTLHead: the paper's technique on a backbone's features, port of
``repro.core.head``.

Per-task linear heads on ANY backbone's features, trained with the
paper's communication-efficient solvers.  ``fit_features`` takes the
features phi(x) in R^p extracted once per task (backbone frozen): the
head problem is then exactly the paper's problem, and every solver the
port registers applies unchanged (the "two-layer network" reading: the
backbone is the bottom layer, the paper's algorithms learn the top).
``as_low_rank`` freezes the learned subspace as factors W ~= U V^T, for
fusion into the backbone's final projection.

The problem is built on ``device`` (default: the card), so a logistic
head on the card runs the ``mtl_grad`` kernel.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Optional, Sequence

import torch

from .._device import DeviceLike
from .methods import MTLProblem, MTLResult, get_solver
from .spectral import truncate_factors

_ROUND_SOLVERS = ("dgsp", "dnsp", "proxgd", "accproxgd", "admm", "dfw",
                  "altmin")


@dataclasses.dataclass
class MTLHeadConfig:
    solver: str = "dgsp"          # any name in core.methods.solver_names()
    rounds: int = 10
    rank: int = 8                 # assumed shared-subspace rank r
    A: float = 10.0               # per-task norm bound
    loss: str = "squared"
    l2: float = 1e-4
    solver_kwargs: dict = dataclasses.field(default_factory=dict)


@dataclasses.dataclass
class MTLHead:
    config: MTLHeadConfig
    W: Optional[torch.Tensor] = None          # (p, m)
    U: Optional[torch.Tensor] = None          # (p, k) learned shared basis
    result: Optional[MTLResult] = None

    def fit_features(self, feats, labels, device: DeviceLike = None
                     ) -> "MTLHead":
        """feats: (m, n, p) per-task feature matrices; labels: (m, n); the
        problem on ``device`` (default: the card)."""
        cfg = self.config
        prob = MTLProblem.make(feats, labels, cfg.loss, A=cfg.A,
                               r=cfg.rank, l2=cfg.l2, device=device)
        kwargs = dict(cfg.solver_kwargs)
        if cfg.solver in _ROUND_SOLVERS:
            kwargs.setdefault("rounds", cfg.rounds)
        res = get_solver(cfg.solver)(prob, **kwargs)
        self.result = res
        self.W = res.W
        U = res.extras.get("U")
        if U is not None and "mask" in res.extras:
            U = U * res.extras["mask"][None, :]
        self.U = U
        return self

    def predict(self, feats: torch.Tensor) -> torch.Tensor:
        """feats: (m, n, p) -> margins (m, n)."""
        if self.W is None:
            raise RuntimeError("head not fitted")
        return torch.einsum("mnp,pm->mn", feats, self.W)

    def as_low_rank(self) -> tuple:
        """Return (U, V) with W ~= U V."""
        if self.U is not None:
            U = self.U[:, torch.linalg.norm(self.U, dim=0) > 0]
            return U, torch.linalg.lstsq(U, self.W).solution
        U, s, V = truncate_factors(self.W, self.config.rank)
        return U * s[None, :], V.T


def extract_features(apply_fn: Callable, params,
                     inputs_per_task: Sequence[torch.Tensor],
                     batch_size: int = 64) -> torch.Tensor:
    """Run a backbone over per-task inputs -> (m, n, p) feature tensor.

    apply_fn(params, batch) must return (batch, p) pooled features.
    """
    outs = []
    for task_inputs in inputs_per_task:
        chunks = [apply_fn(params, task_inputs[i:i + batch_size])
                  for i in range(0, task_inputs.shape[0], batch_size)]
        outs.append(torch.cat(chunks, 0))
    return torch.stack(outs, 0)
