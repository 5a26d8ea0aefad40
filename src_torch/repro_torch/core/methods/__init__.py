"""Solver registry for the paper's multi-task methods."""
from .base import MTLProblem, MTLResult, get_solver, register, solver_names
from . import baselines  # noqa: F401  (registers local/centralize/bestrep/svd_trunc)
from . import convex     # noqa: F401  (registers proxgd/accproxgd/admm/dfw)
from . import greedy     # noqa: F401  (registers dgsp/dnsp; altmin raises)

__all__ = ["MTLProblem", "MTLResult", "get_solver", "register", "solver_names"]
