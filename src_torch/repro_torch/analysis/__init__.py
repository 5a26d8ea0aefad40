"""Static verification of the port's solver programs (DESIGN.md §11).

``python -m repro_torch.analysis`` runs a twin of every registered solver
on the sim and on a one-rank mesh (NCCL on the card, the default; gloo
with ``--device cpu``), under both driver names, holds
the c10d collectives each round issues to the CommLog template that
charged them, runs the sharding, aliasing and carry lints over the same
rounds plus the AST lints of the port's tree, and prints a per-solver
report.

Programmatic entry points:

* :func:`run_analysis` — the matrix; returns an AnalysisReport.
* :func:`trace_solver` / :func:`check_trace` — one cell at a time.
* :func:`verify_static` — what ``repro_torch.solve(...,
  verify="static")`` calls: verify one configuration, raise
  :class:`AnalysisError` on any finding.
* :func:`lint_repo` — the AST lints alone.
"""
from .collectives import CollectiveCall, WalkResult, walk
from .lint import lint_file, lint_repo
from .report import AnalysisReport, CaseReport, Finding
from .verify import (ANALYSIS_CASES, DRIVERS, LAYOUTS, AnalysisError,
                     SolverTrace, StaticCapture, build_problem, check_trace,
                     run_analysis, trace_solver, verify_static)

__all__ = [
    "ANALYSIS_CASES", "AnalysisError", "AnalysisReport", "CaseReport",
    "CollectiveCall", "DRIVERS", "Finding", "LAYOUTS", "SolverTrace",
    "StaticCapture", "WalkResult", "build_problem", "check_trace",
    "lint_file", "lint_repo", "run_analysis", "trace_solver",
    "verify_static", "walk",
]
