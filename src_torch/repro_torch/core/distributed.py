"""Compatibility shims for the reference's historical distributed entry
points.

Port of ``repro.core.distributed``.  No distributed logic lives here:
the protocol runtime is :mod:`repro_torch.runtime` (``SimRuntime`` /
``MeshRuntime``, 1-D over a "tasks" axis or 2-D over
``("tasks", "data")``), the solver bodies live in ``core/methods``, and
the supported entry point is

    repro_torch.solve(prob, method=..., backend="mesh",
                      data_shards=...)      # optional within-task sharding

This module keeps the ``dgsp_distributed`` / ``proxgd_distributed``
call signatures as thin wrappers over that front door, returning the
historical ``DistributedResult``.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from ..api import solve
from ..runtime.mesh import (MeshRuntime, task_data_mesh,  # noqa: F401
                            task_mesh)
from .methods.base import MTLProblem


@dataclasses.dataclass
class DistributedResult:
    """The shim-era result: final predictors and the measured tasks-axis
    collective traffic."""
    W: torch.Tensor
    U: Optional[torch.Tensor]
    rounds: int
    collective_floats_per_chip: int   # measured traffic, for Table-1 checks


def dgsp_distributed(prob: MTLProblem, rounds: int, mesh,
                     axis: str = "tasks", l2: float = 0.0,
                     sv_iters: int = 60, newton: bool = False,
                     damping: float = 1e-4,
                     data_shards: int = 1) -> DistributedResult:
    """DGSP (or DNSP with ``newton=True``) on a device mesh — a wrapper
    over ``repro_torch.solve(..., backend="mesh")``.  ``mesh`` may be
    1-D over ``axis`` or 2-D with a "data" axis (``task_data_mesh``)."""
    kw = dict(rounds=rounds, sv_iters=sv_iters, l2=l2)
    if newton:
        kw["damping"] = damping
    res = solve(prob, method="dnsp" if newton else "dgsp", backend="mesh",
                mesh=mesh, axis=axis, data_shards=data_shards,
                device=prob.device, **kw)
    U = res.extras["U"] * res.extras["mask"][None, :]
    return DistributedResult(
        W=res.W, U=U, rounds=rounds,
        collective_floats_per_chip=res.extras["collective_floats_per_chip"])


def proxgd_distributed(prob: MTLProblem, rounds: int, mesh,
                       axis: str = "tasks", lam: float = 1e-3,
                       eta: Optional[float] = None,
                       data_shards: int = 1) -> DistributedResult:
    """Distributed proximal gradient (Algorithm 4) on a device mesh — a
    wrapper over ``repro_torch.solve``, from W = 0 as the historical
    implementation started."""
    res = solve(prob, method="proxgd", backend="mesh", mesh=mesh, axis=axis,
                data_shards=data_shards, rounds=rounds, lam=lam, eta=eta,
                init="zeros", device=prob.device)
    return DistributedResult(
        W=res.W, U=None, rounds=rounds,
        collective_floats_per_chip=res.extras["collective_floats_per_chip"])
