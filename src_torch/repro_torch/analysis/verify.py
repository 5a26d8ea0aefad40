"""The collective-accounting verifier: the ledger against the c10d ops a
solve issues.

The CommLog is recorded by the runtime primitives while the first round
runs and replayed once per round.  The runtime already holds every later
round's charges to the first round's (``runtime/base.py``); this module
adds the other half of DESIGN.md §11's statement: what moved equals what
was charged.  It runs a TWIN of the configuration: the same solver, the
same problem and layout, on real tensors, for at most
:data:`VERIFY_ROUNDS` rounds, under a :class:`StaticCapture` that records
every c10d collective by round and axis
(:mod:`repro_torch.analysis.collectives`), and throws the twin's result
away.  The reference traces its round program with zero rounds run; an
eager port has no program to trace without running it (the lazy
spectral master branches on values read back to the host), so the twin
runs.  Per round it proves

    {c10d collectives over each axis: op, operand floats, count}
        ==  {CommLog template events that claim to move them}

for the tasks axis (the paper's charged Table-1 traffic, each event's
physical operand: a ``psum`` charge of ``x.numel()`` moves the rank's
pre-reduced ``x.numel() / L``) and the data axis (measured within-task
traffic, operand size × ``repeats``) separately, and flags

* COMM001 / COMM002: a collective not charged, a charge not moved;
* COMM003: a collective outside the round bodies; in the setup of the
  round data, one not over the data axis; among the output gathers that
  hand the global state back, one that is not the single tasks-axis
  all-gather of a sharded leaf; or a round whose collectives or charges
  differ from the first round's: the eager counterpart of a collective
  under ``while``, where
  replaying the first round's template would mis-charge;
* COMM004: ``collective_floats_per_chip`` against the ledger's
  worker->master floats × tasks per rank (0 under the sim), and the
  data-axis counter against its setup and per-round charges;
* COMM005: the charged vectors per round against Table 1;
* COMM006 (:func:`run_analysis`): the ledger identical across layouts
  and both drivers.  ``scan=`` runs the port's one eager loop either
  way; both driver names stay, so the reports line up with the
  reference's;
* SHRD001-003 (:mod:`repro_torch.analysis.shard_lint`).

What it proves is the SHAPE of the protocol in the rounds the twin ran:
which collectives, on which axis, how many floats, how many times.  A
fault that first shows in a later round, or only on other values, is
beyond it; the parity tests own the values.
"""
from __future__ import annotations

import contextlib
import dataclasses
from collections import Counter
from typing import Dict, List, Optional, Tuple

from .._device import DeviceLike, resolve_device
from ..core.comm import TABLE1_VECTORS_PER_ROUND
from ..runtime.base import make_runtime
from .collectives import (OUTPUT, SETUP, CollectiveRecorder, WalkResult,
                          walk)
from .report import AnalysisReport, CaseReport, Finding
from . import shard_lint

LAYOUTS = ("sim", "mesh", "mesh2d")
DRIVERS = ("scan", "eager")

#: rounds a twin solve runs at most (a solve of fewer runs them all):
#: the first round's charges become the template, the later ones must
#: repeat it, and the third shows whether a count keeps changing
VERIFY_ROUNDS = 3

# Toy problem (the reference's): the smallest shapes that keep every
# code path alive (m divisible by 4 task ranks, n by 2 data shards,
# r < p).
_SPEC = dict(p=12, m=8, n=8, r=2)

# Per-solver hyper-parameters of the verification matrix (the
# reference's): few rounds, zeros init where the solver has one.
ANALYSIS_CASES: Dict[str, Dict] = {
    "local": {},
    "bestrep": {},                       # U_star injected by build_problem
    "svd_trunc": {},
    "centralize": {"iters": 4},
    "proxgd": {"rounds": 3, "init": "zeros"},
    "accproxgd": {"rounds": 3, "init": "zeros"},
    "admm": {"rounds": 3, "newton_iters": 2},
    "dfw": {"rounds": 3, "sv_iters": 8},
    "dgsp": {"rounds": 3, "sv_iters": 8},
    "dnsp": {"rounds": 3, "sv_iters": 8},
    "altmin": {"rounds": 3},
}

# The stochastic cells (DESIGN.md §13): every gradient-served solver
# again with real mini-batches and local steps.  Local steps must issue
# no tasks-axis collective (COMM001 fires otherwise) and the Table-1
# vectors per round stay the base solver's (COMM005).
STOCHASTIC_CASES: Dict[str, Dict] = {
    "proxgd": {"rounds": 3, "init": "zeros", "batch_size": 4,
               "local_steps": 2},
    "accproxgd": {"rounds": 3, "init": "zeros", "batch_size": 4,
                  "local_steps": 2},
    "admm": {"rounds": 3, "batch_size": 4, "local_steps": 2},
    "dgsp": {"rounds": 3, "sv_iters": 8, "batch_size": 4,
             "local_steps": 2},
    "dnsp": {"rounds": 3, "sv_iters": 8, "batch_size": 4,
             "local_steps": 2},
}

#: label of a stochastic matrix cell (the report's method column)
STOCHASTIC_TAG = "+sgd"


class AnalysisError(Exception):
    """Static verification failed; ``.findings`` has the diff."""

    def __init__(self, findings: List[Finding]):
        self.findings = list(findings)
        super().__init__("static verification failed:\n" +
                         "\n".join(f"  {f}" for f in self.findings))


class _TwinDone(Exception):
    """Ends a twin solve at the start of its first round past the cap."""


@dataclasses.dataclass
class SolverTrace:
    """Everything one captured twin solve leaves behind."""
    method: str
    layout: str
    driver: str
    backend: str
    axis: str
    data_axis: str
    data_shards: int
    local_tasks: int
    rounds: List[int]              # indices of the rounds the twin ran
    charges: List[Tuple[list, list]]   # per round: (_WireEvent, _DataEvent)
    walked: WalkResult             # the c10d collectives, by phase
    output_gathers: Counter        # {(axis, kind, floats): calls} the
                                   # hand-back of the sharded leaves needs
    setup_data_floats: int
    comm: object                   # the twin's replayed CommLog
    collective_floats_per_chip: int
    data_collective_floats_per_chip: int
    leaves: Dict[str, Tuple[int, bool]]   # name -> (global numel, sharded)
    aliased: List[str]             # SHRD002 observations
    drift: List[str]               # SHRD003 observations


class StaticCapture:
    """Attach as ``runtime._capture`` and enter around one solve: the
    runtime hands it each round's state and charges
    (``ProtocolRuntime._run_body``), and it records the c10d collectives
    of every phase.  After ``rounds`` rounds it ends the twin."""

    def __init__(self, rounds: int = VERIFY_ROUNDS):
        self.max_rounds = int(rounds)
        self.recorder = CollectiveRecorder()
        self.rt = None
        self.rounds: List[int] = []
        self.charges: List[Tuple[list, list]] = []
        self.leaves: Dict[str, Tuple[int, bool]] = {}
        self.aliased: List[str] = []
        self.drift: List[str] = []
        self.output_gathers: Counter = Counter()
        self._seen: set = set()
        self._before: list = []

    def __enter__(self):
        self.recorder.__enter__()
        return self

    def __exit__(self, *exc):
        return self.recorder.__exit__(*exc)

    @contextlib.contextmanager
    def phase(self, name):
        prev = self.recorder.phase
        self.recorder.phase = name
        try:
            yield
        finally:
            self.recorder.phase = prev

    # -- the runtime's hooks ---------------------------------------------
    def begin(self, rt, state, sharded) -> None:
        if self.rt is not None:
            raise RuntimeError("StaticCapture already holds a solve")
        self.rt = rt
        self.recorder.name_group(getattr(rt, "_tasks_group", None),
                                 getattr(rt, "axis", "tasks"))
        self.recorder.name_group(getattr(rt, "_data_group", None),
                                 rt.data_axis)
        for key, value in state.items():
            for path, leaf in shard_lint.flat_leaves(value, f"[{key!r}]"):
                if hasattr(leaf, "numel"):
                    self.leaves[f"state{path}"] = (leaf.numel(),
                                                   key in sharded)
        keep = rt._data_leaves
        for key, leaf in rt.prob.worker_data().items():
            if keep is None or key in keep:
                self.leaves[f"data[{key!r}]"] = (leaf.numel(), True)

    def round_start(self, rt, k: int, state) -> None:
        if len(self.rounds) >= self.max_rounds:
            raise _TwinDone()
        self._before = shard_lint.versions(state)

    def round_end(self, rt, k: int, state_in, state_out) -> None:
        self.rounds.append(k)
        self.charges.append((list(rt._round_events),
                             list(rt._round_data_events)))
        # a leaf is reported once, at the first round that shows it
        for out, hits in (
                (self.aliased, shard_lint.written_in_place(k, self._before)),
                (self.drift, shard_lint.drift(k, state_in, state_out))):
            for path, msg in hits:
                if (id(out), path) not in self._seen:
                    self._seen.add((id(out), path))
                    out.append(msg)
        self._before = []

    def hand_back(self, rt, value, shard_it: bool) -> None:
        """A state entry is handed back to the caller: a sharded one on a
        mesh needs one tasks-axis all-gather of each leaf's local
        columns, anything else none."""
        if rt.name != "mesh" or not shard_it:
            return
        for _, leaf in shard_lint.flat_leaves(value, ""):
            if hasattr(leaf, "numel") and leaf.ndim:
                self.output_gathers[(getattr(rt, "axis", "tasks"),
                                     "all_gather", leaf.numel())] += 1

    def charges_drift(self) -> bool:
        return any(c != self.charges[0] for c in self.charges[1:])

    def trace(self, method: str, layout: str, driver: str) -> SolverTrace:
        rt = self.rt
        return SolverTrace(
            method=method, layout=layout, driver=driver, backend=rt.name,
            axis=getattr(rt, "axis", "tasks"), data_axis=rt.data_axis,
            data_shards=rt.data_shards, local_tasks=rt.local_tasks,
            rounds=list(self.rounds), charges=list(self.charges),
            walked=walk(self.recorder.calls, self.rounds),
            output_gathers=Counter(self.output_gathers),
            setup_data_floats=rt.setup_data_floats, comm=rt.comm,
            collective_floats_per_chip=rt.collective_floats_per_chip,
            data_collective_floats_per_chip=(
                rt.data_collective_floats_per_chip),
            leaves=dict(self.leaves), aliased=list(self.aliased),
            drift=list(self.drift))


# ---------------------------------------------------------------------------
# running one twin
# ---------------------------------------------------------------------------
def build_problem(loss: str = "squared", gram: bool = True,
                  device: DeviceLike = None):
    """The deterministic toy instance the matrix runs against (the
    reference's draw), on ``device`` (the card unless the CPU is asked
    for).  Returns ``(prob, extras)``; extras carries the oracle
    ``U_star`` the bestrep baseline requires."""
    from ..core import prng
    from ..core.methods import MTLProblem
    from ..core.spectral import truncate_factors
    from ..data.synthetic import SimSpec, generate

    device = resolve_device(device)
    spec = SimSpec(p=_SPEC["p"], m=_SPEC["m"], r=_SPEC["r"], n=_SPEC["n"],
                   task="regression" if loss == "squared"
                   else "classification")
    Xs, ys, Wstar, _ = generate(prng.PRNGKey(0, device=device), spec,
                                device=device)
    prob = MTLProblem.make(Xs, ys, loss_name=loss, gram=gram, r=spec.r,
                           device=device)
    U_star, _, _ = truncate_factors(Wstar, spec.r)
    return prob, {"U_star": U_star}


def layout_runtime(prob, layout: str):
    """A fresh runtime for one verification-matrix layout; the mesh
    layouts span the process group (``init_cluster`` first)."""
    from ..runtime.mesh import MeshRuntime, task_data_mesh, task_mesh
    dev = prob.device.type
    if layout == "sim":
        return make_runtime("sim", prob)
    if layout == "mesh":
        return MeshRuntime(prob, mesh=task_mesh(device=dev))
    if layout == "mesh2d":
        return MeshRuntime(prob, mesh=task_data_mesh(2, device=dev),
                           data_shards=2)
    raise ValueError(f"unknown layout {layout!r}; have {LAYOUTS}")


def capture_solve(rt, prob, method: str, *, layout: str, scan: bool = True,
                  hp: Optional[Dict] = None,
                  rounds: int = VERIFY_ROUNDS) -> SolverTrace:
    """Run ``method`` as a twin on runtime ``rt`` for at most ``rounds``
    rounds under a :class:`StaticCapture`; its result is thrown away."""
    from .. import api

    cap = StaticCapture(rounds)
    rt._capture = cap
    try:
        with cap:
            api.solve(prob, method=method, runtime=rt, scan=scan,
                      device=prob.device, **(hp or {}))
    except _TwinDone:
        pass
    except RuntimeError:
        # the runtime refuses a round whose charges differ from the
        # first round's; the capture holds both, for COMM003
        if not (cap.rt is not None and cap.charges_drift()):
            raise
    finally:
        rt._capture = None
    if cap.rt is None:
        raise RuntimeError(f"solver {method!r} never entered run_rounds — "
                           f"nothing to verify")
    return cap.trace(method, layout, "scan" if scan else "eager")


def trace_solver(method: str, layout: str, driver: str = "scan",
                 prob=None, extras: Optional[Dict] = None,
                 hp: Optional[Dict] = None,
                 device: DeviceLike = None) -> SolverTrace:
    """Capture one cell of the matrix (a twin of at most
    :data:`VERIFY_ROUNDS` rounds), on ``prob`` or else on
    :func:`build_problem`'s on ``device``."""
    if prob is None:
        prob, extras = build_problem(device=device)
    hp = dict(ANALYSIS_CASES.get(method, {}) if hp is None else hp)
    if method == "bestrep":
        hp.setdefault("U_star", (extras or {})["U_star"])
    return capture_solve(layout_runtime(prob, layout), prob, method,
                         layout=layout, scan=driver == "scan", hp=hp)


# ---------------------------------------------------------------------------
# checking one trace
# ---------------------------------------------------------------------------
def _charged(trace: SolverTrace) -> Counter:
    """The charges' claim over the twin's rounds, ``{(axis, kind,
    floats): calls}``."""
    c: Counter = Counter()
    for events, data_events in trace.charges:
        for ev in events:
            if ev.kind != "none":      # sim / broadcast: no collective
                c[(trace.axis, ev.kind, ev.payload)] += 1
        for ev in data_events:
            c[(trace.data_axis, ev.kind, ev.floats)] += ev.repeats
    return c


def _counter_diff(expected: Counter, measured: Counter, trace: SolverTrace,
                  findings: List[Finding], where: str) -> None:
    """A finding for every (axis, collective, floats) where the charges
    and the recorded c10d ops disagree, naming the op and the axis."""
    n = len(trace.rounds)
    span = "round 1" if n == 1 else f"rounds 1-{n}"
    for key in sorted(set(expected) | set(measured)):
        exp, got = expected.get(key, 0), measured.get(key, 0)
        if exp == got:
            continue
        axis, kind, floats = key
        ops = sorted({c.op for calls in trace.walked.rounds.values()
                      for c in calls if (c.axis, c.kind, c.floats) == key})
        named = " / ".join(ops) if ops else f"no c10d op ({kind})"
        if got > exp:
            findings.append(Finding(
                "COMM001",
                f"{named} ({kind}) of {floats} floats over axis {axis!r} "
                f"runs {got}x in {span} but the ledger template charges "
                f"it only {exp}x: an uncharged collective", where))
        else:
            findings.append(Finding(
                "COMM002",
                f"the ledger template charges a {kind} of {floats} floats "
                f"over axis {axis!r} {exp}x in {span} but {named} runs "
                f"{got}x: a charge that moves nothing", where))


def check_trace(trace: SolverTrace) -> CaseReport:
    """Verify one captured twin; every disagreement becomes a Finding."""
    where = f"{trace.method}/{trace.layout}/{trace.driver}"
    rep = CaseReport(method=trace.method, layout=trace.layout,
                     driver=trace.driver, rounds=trace.comm.rounds)
    findings = rep.findings
    walked = trace.walked

    # structural: collectives outside the rounds, rounds that differ
    for issue in walked.issues:
        findings.append(Finding("COMM003", issue, where))
    for i, charged in enumerate(trace.charges[1:], start=1):
        if charged != trace.charges[0]:
            findings.append(Finding(
                "COMM003",
                f"round {trace.rounds[i] + 1} charges {charged} but round "
                f"{trace.rounds[0] + 1} charged {trace.charges[0]}: the "
                f"replayed template would mis-charge it", where))

    # the phases around the rounds: the round data's setup all-reduces
    # over the data axis alone, and the hand-back gathers each sharded
    # leaf once; anything else there is a collective nothing charges
    for c in walked.phase_calls(SETUP):
        if c.axis != trace.data_axis:
            findings.append(Finding(
                "COMM003",
                f"{c.describe()}: the round data's setup reduces over "
                f"axis {trace.data_axis!r} only, and the replayed "
                f"template never charges it", where))
    handed = Counter((c.axis, c.kind, c.floats)
                     for c in walked.phase_calls(OUTPUT))
    for key in sorted(set(handed) | set(trace.output_gathers)):
        exp, got = trace.output_gathers.get(key, 0), handed.get(key, 0)
        if exp != got:
            axis, kind, floats = key
            ops = sorted({c.op for c in walked.phase_calls(OUTPUT)
                          if (c.axis, c.kind, c.floats) == key})
            named = " / ".join(ops) if ops else f"no c10d op ({kind})"
            findings.append(Finding(
                "COMM003",
                f"{named} ({kind}) of {floats} floats over axis {axis!r} "
                f"runs {got}x in the output gathers, but handing back the "
                f"sharded leaves needs it {exp}x", where))

    # every axis: the charges against the c10d ops of the same rounds
    _counter_diff(_charged(trace), walked.tally(), trace, findings, where)

    # ledger arithmetic: the replayed counters against the template
    uplink = trace.comm.floats_by_direction("worker->master")
    if trace.backend == "mesh":
        want = uplink * trace.local_tasks
        if trace.collective_floats_per_chip != want:
            findings.append(Finding(
                "COMM004",
                f"collective_floats_per_chip="
                f"{trace.collective_floats_per_chip} != ledger uplink "
                f"{uplink} floats/machine x {trace.local_tasks} "
                f"tasks/chip = {want}", where))
    elif trace.collective_floats_per_chip != 0:
        findings.append(Finding(
            "COMM004", f"sim backend measured "
            f"{trace.collective_floats_per_chip} collective floats; "
            f"the simulated cluster moves none", where))
    first_data = trace.charges[0][1] if trace.charges else []
    data_round = sum(ev.floats * ev.repeats for ev in first_data)
    want_data = trace.setup_data_floats + data_round * len(trace.rounds)
    if trace.data_collective_floats_per_chip != want_data:
        findings.append(Finding(
            "COMM004",
            f"data_collective_floats_per_chip="
            f"{trace.data_collective_floats_per_chip} != setup "
            f"{trace.setup_data_floats} + per-round {data_round} x "
            f"{len(trace.rounds)} rounds = {want_data}", where))
    setup = sum(c.floats for c in walked.phase_calls(SETUP)
                if c.axis == trace.data_axis)
    if setup != trace.setup_data_floats:
        findings.append(Finding(
            "COMM004",
            f"the round data's setup all-reduces {setup} floats over axis "
            f"{trace.data_axis!r}; the runtime counts "
            f"{trace.setup_data_floats}", where))

    # Table 1: charged vectors per round
    t1 = TABLE1_VECTORS_PER_ROUND.get(trace.method.split("+")[0])
    if t1 is not None and trace.comm.rounds:
        got = trace.comm.per_round_vectors()
        if got != t1:
            findings.append(Finding(
                "COMM005",
                f"ledger charges {got} vectors/machine/round; Table 1 "
                f"says {t1}", where))

    # sharding, aliasing, carry drift
    findings.extend(shard_lint.lint_program(trace))

    # report numbers
    rounds = walked.rounds.values()
    rep.charged_floats_per_machine = trace.comm.floats_per_machine()
    rep.charged_vectors_per_round = trace.comm.per_round_vectors()
    rep.measured_task_floats_per_chip = sum(
        c.floats for calls in rounds for c in calls if c.axis == trace.axis)
    rep.measured_data_floats_per_chip = setup + sum(
        c.floats for calls in rounds for c in calls
        if c.axis == trace.data_axis)
    rep.collective_eqns = len(walked.rounds[trace.rounds[0]]) \
        if trace.rounds else 0
    return rep


# ---------------------------------------------------------------------------
# the suite: every solver x layout x driver, plus cross-case invariants
# ---------------------------------------------------------------------------
def _ledger_signature(trace: SolverTrace) -> Tuple:
    """The ledger as a comparable value: per-event tuples + round count.
    Must be IDENTICAL across layouts and drivers."""
    return (trace.comm.rounds,
            tuple((e.round, e.direction, e.vectors, e.dim)
                  for e in trace.comm.events))


def run_analysis(methods: Optional[List[str]] = None,
                 layouts: Tuple[str, ...] = LAYOUTS,
                 drivers: Tuple[str, ...] = DRIVERS,
                 lint_paths: bool = True,
                 device: DeviceLike = None) -> AnalysisReport:
    """The verification matrix on ``layouts`` (the mesh ones over the
    current process group) + the repo lints, on ``device`` (the card
    unless the CPU is asked for); returns the report."""
    from ..core.methods import solver_names
    from .lint import lint_repo

    if methods is None:
        methods = sorted(solver_names())
    prob, extras = build_problem(device=device)
    report = AnalysisReport()
    by_method: Dict[str, List[Tuple[str, SolverTrace]]] = {}
    cells = [(m, None) for m in methods] + \
            [(m, STOCHASTIC_CASES[m]) for m in sorted(STOCHASTIC_CASES)
             if m in methods]
    for method, hp in cells:
        label = method if hp is None else method + STOCHASTIC_TAG
        for layout in layouts:
            for driver in drivers:
                trace = trace_solver(method, layout, driver, prob=prob,
                                     extras=extras, hp=hp)
                trace.method = label
                report.cases.append(check_trace(trace))
                by_method.setdefault(label, []).append(
                    (f"{layout}/{driver}", trace))

    for method, traces in by_method.items():
        base_name, base = traces[0]
        base_sig = _ledger_signature(base)
        for name, trace in traces[1:]:
            if _ledger_signature(trace) != base_sig:
                report.cross_findings.append(Finding(
                    "COMM006",
                    f"{method}: ledger under {name} differs from "
                    f"{base_name} — the CommLog must be bit-identical "
                    f"across layouts and drivers", method))

    if lint_paths:
        report.lint_findings.extend(lint_repo())
    return report


def verify_static(prob, method: str, *, backend: str = "sim", mesh=None,
                  axis: str = "tasks", data_shards: int = 1,
                  data_axis: str = "data", scan: Optional[bool] = None,
                  **hp) -> CaseReport:
    """The ``repro_torch.solve(..., verify="static")`` entry point: run a
    twin of the requested configuration (same problem, same layout, at
    most :data:`VERIFY_ROUNDS` rounds, its result thrown away), verify
    it, and raise :class:`AnalysisError` on any finding."""
    rt = make_runtime(backend, prob, mesh=mesh, axis=axis,
                      data_axis=data_axis, data_shards=data_shards)
    layout = {"sim": "sim", "mesh": "mesh"}[rt.name] \
        if rt.data_shards == 1 else "mesh2d"
    trace = capture_solve(rt, prob, method, layout=layout,
                          scan=True if scan is None else scan, hp=hp)
    rep = check_trace(trace)
    if not rep.ok:
        raise AnalysisError(rep.findings)
    return rep
