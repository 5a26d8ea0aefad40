"""Backend-agnostic runtime for the paper's master/worker protocol.

Port of ``repro.runtime.base``.  Every algorithm in the paper (Table 1)
is an instance of one round structure:

    workers:  compute a per-task message from local data      (worker_map)
    send:     task-columns flow to the master                 (gather_columns /
                                                               gather_tasks /
                                                               sum_tasks)
    master:   a small dense computation on the gathered state (plain torch ops)
    reply:    the master's answer returns to the workers      (broadcast)

A :class:`ProtocolRuntime` provides exactly those primitives plus a
driver (:meth:`run_rounds` / :meth:`one_shot`) that executes the round
body and keeps the communication ledger.  The port has one backend so
far, ``SimRuntime`` (the simulated cluster: all m tasks in one worker
view, collectives are identities); the mesh backend and the 2-D
``("tasks", "data")`` layout come with ROADMAP Queue 1 item 5.

Accounting keeps the reference's model.  The primitives record their
charges while the FIRST round runs; that template is replayed into the
:class:`~repro_torch.core.comm.CommLog` once per round, so the ledger
equals the reference's by construction.  Torch has no ``lax.scan``:
every round runs the body eagerly, so the driver also checks that each
later round charges exactly the template, and raises if one does not.
``scan=True`` and ``scan=False`` run the same loop (the argument stays
for signature parity), so the two give identical W and ledgers.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import torch

from ..core.comm import CommLog

# A round body: (k, state, data) -> state.  ``k`` is the round index (a
# Python int), ``state`` a dict of tensors or small dicts of them (e.g. a
# spectral-engine carry), ``data`` the worker-local data view — a dict
# with ``Xs`` (m,n,p) / ``ys`` (m,n) plus any cached per-task statistics
# (``gram_A``/``gram_b``), every leaf stacked over the task axis.
RoundBody = Callable[[int, Dict[str, object], Dict[str, torch.Tensor]],
                     Dict[str, object]]

MESH_TODO = ("the mesh backend and data_shards > 1 come with the mesh "
             "runtime, ROADMAP Queue 1 item 5")


@dataclasses.dataclass
class RecordSpec:
    """Snapshot cadence for one state entry.

    ``sink.record(round, value)`` receives ``state[key]`` after every
    ``every``-th round (and always after the final round).  Snapshots are
    the state's own tensors, left on the device.
    """
    sink: object          # anything with .record(rnd: int, value)
    every: int = 1
    key: str = "W"

    def snap_rounds(self, rounds: int) -> List[int]:
        """0-indexed rounds whose post-state is snapshotted."""
        return [t for t in range(rounds)
                if (t + 1) % self.every == 0 or t == rounds - 1]


@dataclasses.dataclass
class _WireEvent:
    """One primitive call recorded while a round body runs."""
    direction: str      # "worker->master" | "master->worker"
    vectors: int        # ledger: vectors per machine (paper accounting)
    dim: int            # ledger: dimension of each vector
    note: str
    wire_floats: int    # protocol floats this device's machines feed a
                        # collective: 0 under SimRuntime, where none runs


class ProtocolRuntime:
    """Abstract backend. Holds the problem, the ledger, and the driver."""

    name = "abstract"

    def __init__(self, prob):
        self.prob = prob
        self.comm = CommLog(m=prob.m)
        # worker->master floats fed into collectives (0 under sim)
        self.collective_floats_per_chip = 0
        # data-axis collective floats (0 while only one data shard exists)
        self.data_collective_floats_per_chip = 0
        self.data_shards = 1
        self._recording = False
        self._template: List[_WireEvent] = []
        self._round_events: List[_WireEvent] = []
        self._data_leaves: Optional[Tuple[str, ...]] = None
        self._used = False

    # ------------------------------------------------------------------
    # protocol primitives — call these inside a round body only
    # ------------------------------------------------------------------
    def worker_map(self, fn, in_axes, out_axes=0):
        """Lift a per-task computation over the worker-local task axis
        (``torch.func.vmap`` of ``fn``)."""
        return torch.func.vmap(fn, in_dims=in_axes, out_dims=out_axes)

    def local_slice(self, x: torch.Tensor, axis: int = -1) -> torch.Tensor:
        """This worker view's task-columns of a replicated master array
        (free; the charge sits on ``broadcast``)."""
        raise NotImplementedError

    def gather_columns(self, x: torch.Tensor, note: str = "") -> torch.Tensor:
        """workers -> master: stack per-task column messages to (d, m).
        Ledger: each machine sends 1 vector of dimension d."""
        raise NotImplementedError

    def gather_tasks(self, x: torch.Tensor, note: str = "") -> torch.Tensor:
        """workers -> master: gather a per-task payload along axis 0.
        Ledger: each machine sends prod(shape[1:-1]) vectors of dimension
        shape[-1]."""
        raise NotImplementedError

    def sum_tasks(self, x: torch.Tensor, note: str = "") -> torch.Tensor:
        """workers -> master: sum a per-task payload over ALL m tasks.
        Ledger: each machine sends its payload once."""
        raise NotImplementedError

    def broadcast(self, x: torch.Tensor, note: str = "",
                  vectors: Optional[int] = None,
                  dim: Optional[int] = None) -> torch.Tensor:
        """master -> workers: publish master state.

        A no-op computationally but the protocol's downlink, and charged:
        a (d,) vector costs 1 vector of dim d per machine; a (d, m)
        matrix costs each machine its own column; any other matrix is
        charged column-wise to every machine.  Pass ``vectors``/``dim``
        (both) to override.
        """
        if (vectors is None) != (dim is None):
            raise ValueError("broadcast accounting override needs both "
                             "vectors= and dim=, or neither")
        if vectors is None:
            if x.ndim == 1:
                vectors, dim = 1, x.shape[0]
            elif x.ndim == 2 and x.shape[1] == self.prob.m:
                vectors, dim = 1, x.shape[0]
            elif x.ndim == 2:
                vectors, dim = x.shape[1], x.shape[0]
            else:
                vectors, dim = int(x.numel() // x.shape[-1]), x.shape[-1]
        self._charge("master->worker", vectors, dim, note, wire=0)
        return x

    # ------------------------------------------------------------------
    # data-axis primitives: identities while only one data shard exists
    # ------------------------------------------------------------------
    def psum_data(self, x: torch.Tensor, note: str = "",
                  repeats: int = 1) -> torch.Tensor:
        return x

    def pmean_data(self, x: torch.Tensor, note: str = "",
                   repeats: int = 1) -> torch.Tensor:
        return x

    def gather_samples(self, x: torch.Tensor, axis: int = 1,
                       note: str = "") -> torch.Tensor:
        return x

    # ------------------------------------------------------------------
    # ledger plumbing
    # ------------------------------------------------------------------
    @staticmethod
    def _payload_vectors(x) -> Tuple[int, int]:
        """Ledger (vectors, dim) of one task's payload in a per-task
        stack ``x`` of shape (L, ...): prod(shape[1:-1]) vectors of
        dimension shape[-1]."""
        payload = x.shape[1:]
        vectors = 1
        for s in payload[:-1]:
            vectors *= int(s)
        return vectors, int(payload[-1])

    def _charge(self, direction: str, vectors: int, dim: int, note: str,
                wire: int) -> None:
        if self._recording:
            self._round_events.append(
                _WireEvent(direction, int(vectors), int(dim), note, int(wire)))

    def _replay_round(self, count_round: bool) -> None:
        if count_round:
            self.comm.begin_round()
        for ev in self._template:
            self.comm.send(ev.direction, ev.vectors, ev.dim, ev.note)
            self.collective_floats_per_chip += ev.wire_floats

    # ------------------------------------------------------------------
    # drivers
    # ------------------------------------------------------------------
    def _round_data(self) -> Dict[str, torch.Tensor]:
        """The worker-data leaves bound into the round loop: the full
        dict, pruned to the solver-declared ``data_leaves`` when given."""
        data = self.prob.worker_data()
        if self._data_leaves is None:
            return data
        keep = set(self._data_leaves)
        return {k: v for k, v in data.items() if k in keep}

    @staticmethod
    def _as_records(record) -> Tuple[RecordSpec, ...]:
        """None, one RecordSpec, or a sequence of them -> a tuple."""
        if record is None:
            return ()
        if isinstance(record, RecordSpec):
            return (record,)
        return tuple(record)

    def _claim(self) -> None:
        if self._used:
            raise RuntimeError(
                "a ProtocolRuntime carries one solve's ledger and cannot "
                "be reused — its CommLog and collective-traffic counters "
                "would accumulate across solves; construct a fresh runtime "
                "(or let repro_torch.solve build one) per call")
        self._used = True

    def _run_body(self, body: RoundBody, k: int, state, data):
        """Run one round and return its state; the first round's charges
        become the template, every later round must repeat them."""
        self._round_events = []
        self._recording = True
        try:
            state = body(k, state, data)
        finally:
            self._recording = False
        if k == 0:
            self._template = self._round_events
        elif self._round_events != self._template:
            raise RuntimeError(
                f"round {k} charged {self._round_events} but round 0 "
                f"charged {self._template}: every round of a protocol must "
                f"run the same collectives, or the replayed ledger would "
                f"be wrong")
        return state

    def run_rounds(self, rounds: int, body: RoundBody,
                   state: Dict[str, object],
                   sharded: Sequence[str] = (),
                   record=None,        # RecordSpec | sequence of them
                   count_rounds: bool = True, scan: bool = False,
                   data_leaves: Optional[Sequence[str]] = None
                   ) -> Dict[str, object]:
        """Execute ``rounds`` protocol rounds of ``body``.

        ``state`` is a dict of global tensors (or small dicts of them);
        ``sharded`` names the entries that live on the workers (their
        task columns; the same thing as master state under sim).
        ``data_leaves`` names the worker-data leaves the body reads
        (None = all).  Each round runs ``body`` once; the charges of
        round 0 are the per-round template, replayed into ``self.comm``
        after every round (see the module docstring).  ``record``
        snapshots state entries on their cadences.  ``scan`` is accepted
        for parity with the reference and changes nothing.
        """
        self._claim()
        self._template = []
        self._data_leaves = None if data_leaves is None else \
            tuple(data_leaves)
        records = self._as_records(record)
        data = self._round_data()
        snap_sets = [set(r.snap_rounds(rounds)) for r in records]
        for t in range(rounds):
            state = self._run_body(body, t, state, data)
            self._replay_round(count_rounds)
            for r, sset in zip(records, snap_sets):
                if t in sset:
                    r.sink.record(t + 1, state[r.key])
        return state

    def one_shot(self, body: RoundBody, state: Dict[str, object],
                 sharded: Sequence[str] = (), count_round: bool = True,
                 scan: bool = False,
                 data_leaves: Optional[Sequence[str]] = None
                 ) -> Dict[str, object]:
        """Single protocol exchange (the one-shot baselines)."""
        return self.run_rounds(1, body, state, sharded=sharded,
                               count_rounds=count_round, scan=scan,
                               data_leaves=data_leaves)


def make_runtime(backend: str, prob, *, mesh=None, axis: str = "tasks",
                 data_axis: str = "data", data_shards: int = 1
                 ) -> ProtocolRuntime:
    """Construct a fresh runtime for one solve.

    ``backend``: "sim".  "mesh" or ``data_shards > 1`` raise
    ``NotImplementedError`` until the mesh runtime is ported.
    """
    if backend not in ("sim", "mesh"):
        raise ValueError(f"unknown backend {backend!r}; have 'sim', 'mesh'")
    if backend == "mesh" or data_shards != 1:
        raise NotImplementedError(MESH_TODO)
    from .sim import SimRuntime
    return SimRuntime(prob)
