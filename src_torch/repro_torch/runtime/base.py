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
body and keeps the communication ledger.  Two backends implement them:

* ``SimRuntime``  — the simulated cluster: one worker view holds all m
  tasks and the collectives are identities that only charge.
* ``MeshRuntime`` — one process per device of a
  ``torch.distributed`` device mesh: each rank holds its ``m/T`` tasks,
  runs the same body on them, and the collectives are real
  (all-gather / all-reduce over the "tasks" group; the replicated
  master runs on every rank).

The data axis.  ``data_shards > 1`` turns the runtime into a 2-D
``("tasks", "data")`` layout: each task's ``n`` rows are split into
``data_shards`` contiguous blocks, and per-task sample statistics are
reduced over the data axis with :meth:`pmean_data` / :meth:`psum_data`
(all-reduces over the "data" group on the mesh; identities when
``data_shards == 1``).  ``SimRuntime`` emulates that axis on one
device.  The ledger charges only tasks-axis traffic, so it is the same
for every layout; data-axis floats are measured into
``data_collective_floats_per_chip``.

Accounting keeps the reference's model.  The primitives record their
charges while the FIRST round runs; that template is replayed into the
:class:`~repro_torch.core.comm.CommLog` once per round, so the ledger
equals the reference's by construction (a resumed solve records the
template in the first round it runs and checks it against the stored
one, ``runtime.recovery``).  Torch has no ``lax.scan``:
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
# with ``Xs`` (L,n,p) / ``ys`` (L,n) plus any cached per-task statistics
# (``gram_A``/``gram_b``), every leaf stacked over the worker view's L
# tasks (all m under sim, the rank's block under the mesh).  With
# ``data_shards > 1`` the leaves in ``SAMPLE_AXIS_LEAVES`` hold only the
# shard's ``n / data_shards`` rows.
RoundBody = Callable[[int, Dict[str, object], Dict[str, torch.Tensor]],
                     Dict[str, object]]

# Worker-data leaves whose axis 1 is the per-task sample axis: the
# leaves a 2-D layout splits over the data axis.  The Gram cache has no
# sample axis and is the same on every data shard.
SAMPLE_AXIS_LEAVES = frozenset({"Xs", "ys"})


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
                        # collective: L x the per-machine payload under
                        # the mesh, 0 under SimRuntime, where none runs
    kind: str = "none"  # the collective the call runs ("all_gather",
                        # "psum", or "none" where none runs)
    payload: int = 0    # floats in that collective's operand on this
                        # device (psum: after the local pre-reduction)


@dataclasses.dataclass
class _DataEvent:
    """One data-axis collective recorded while a round body runs."""
    kind: str           # "psum" | "all_gather"
    floats: int         # operand floats per device per call
    repeats: int = 1    # executions per round the one call stands for
    note: str = ""


class ProtocolRuntime:
    """Abstract backend. Holds the problem, the ledger, and the driver."""

    name = "abstract"

    def __init__(self, prob):
        self.prob = prob
        self.comm = CommLog(m=prob.m)
        # worker->master protocol floats this device's machines fed into
        # collectives: the ledger's per-machine uplink times tasks per
        # device under the mesh, 0 under sim where no collective runs
        self.collective_floats_per_chip = 0
        # data-axis collective floats this device fed (psum / pmean /
        # all_gather over "data"): never charged to the CommLog, 0 under
        # sim and whenever data_shards == 1
        self.data_collective_floats_per_chip = 0
        # the part of it spent outside the rounds (the 2-D Gram cache)
        self.setup_data_floats = 0
        self.data_shards = 1
        self.data_axis = "data"
        self._recording = False
        self._template: List[_WireEvent] = []
        self._round_events: List[_WireEvent] = []
        self._data_template: List[_DataEvent] = []
        self._round_data_events: List[_DataEvent] = []
        self._data_leaves: Optional[Tuple[str, ...]] = None
        self._used = False
        # when set (``runtime.recovery.SolveCheckpointer``, attached by
        # ``repro_torch.solve(..., ckpt_dir=)``), run_rounds hands its
        # whole drive to the segmented, resumable driver
        self._ckpt = None

    # ------------------------------------------------------------------
    # topology
    # ------------------------------------------------------------------
    @property
    def local_tasks(self) -> int:
        """Tasks held by one worker view (m under sim, m/T on the mesh)."""
        raise NotImplementedError

    def data_index(self) -> int:
        """Index of this shard along the data axis (0 when
        ``data_shards == 1``).  The stochastic batch sampler folds it
        into its key chain, so each shard of a 2-D layout draws the
        reference's rows for that shard (``worker_ops.batch_indices``)."""
        return 0

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
    # data-axis primitives: within-task sharding
    # ------------------------------------------------------------------
    def psum_data(self, x: torch.Tensor, note: str = "",
                  repeats: int = 1) -> torch.Tensor:
        """Sum a per-shard partial statistic over the data axis (one
        normalised by the GLOBAL n, e.g. partial Grams ``X_s^T X_s / n``).
        Identity when ``data_shards == 1``.  Never charged to the
        CommLog; on the mesh the ``x.numel() * repeats`` floats are
        measured into ``data_collective_floats_per_chip``."""
        if self.data_shards == 1:
            return x
        if self._count_data_wire:
            self._charge_data("psum", x.numel(), repeats, note)
        return self._psum_data(x)

    def pmean_data(self, x: torch.Tensor, note: str = "",
                   repeats: int = 1) -> torch.Tensor:
        """Average a per-shard statistic normalised by the LOCAL row
        count (e.g. ``(1/n_local) X_s^T l'``) over the data axis: the
        shards' sum divided by ``data_shards``.  Identity when
        ``data_shards == 1``; accounting as :meth:`psum_data`."""
        if self.data_shards == 1:
            return x
        if self._count_data_wire:
            self._charge_data("psum", x.numel(), repeats, note)
        return self._psum_data(x) / self.data_shards

    def gather_samples(self, x: torch.Tensor, axis: int = 1,
                       note: str = "") -> torch.Tensor:
        """Reassemble the full sample axis of a per-task stack from its
        data shards, in row order, on every shard (the Centralize
        baseline calls it before its tasks-axis shipment, so the charged
        event keeps its 1-D shape).  Identity when ``data_shards == 1``;
        measured, never charged."""
        if self.data_shards == 1:
            return x
        if self._count_data_wire:
            self._charge_data("all_gather", x.numel(), 1, note)
        return self._gather_samples(x, axis)

    # Whether this backend moves bytes over the data axis (the mesh: yes;
    # the sim emulation: no, as it measures 0 on the tasks axis too).
    _count_data_wire = False

    def _psum_data(self, x):
        raise NotImplementedError

    def _gather_samples(self, x, axis):
        raise NotImplementedError

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

    def _records_here(self) -> bool:
        """Whether the calling worker view records charges (all but the
        sim emulation's shards other than 0, which repeat shard 0's)."""
        return True

    def _charge(self, direction: str, vectors: int, dim: int, note: str,
                wire: int, kind: str = "none", payload: int = 0) -> None:
        if self._recording and self._records_here():
            self._round_events.append(
                _WireEvent(direction, int(vectors), int(dim), note,
                           int(wire), kind, int(payload)))

    def _charge_data(self, kind: str, floats: int, repeats: int = 1,
                     note: str = "") -> None:
        """Measure a data-axis collective (never enters the CommLog).
        Inside a round it joins the round's data template; outside one
        (the 2-D Gram cache) it counts at once, as setup."""
        if self._recording:
            if self._records_here():
                self._round_data_events.append(
                    _DataEvent(kind, int(floats), int(repeats), note))
        else:
            self.data_collective_floats_per_chip += int(floats) * int(repeats)
            self.setup_data_floats += int(floats) * int(repeats)

    def _replay_round(self, count_round: bool) -> None:
        if count_round:
            self.comm.begin_round()
        for ev in self._template:
            self.comm.send(ev.direction, ev.vectors, ev.dim, ev.note)
            self.collective_floats_per_chip += ev.wire_floats
        self.data_collective_floats_per_chip += sum(
            ev.floats * ev.repeats for ev in self._data_template)

    # ------------------------------------------------------------------
    # drivers
    # ------------------------------------------------------------------
    def _worker_data(self) -> Dict[str, torch.Tensor]:
        """This backend's worker-data view (the whole problem under sim
        with one data shard)."""
        return self.prob.worker_data()

    def _round_data(self):
        """The worker-data leaves bound into the round loop: the
        backend's view, pruned to the solver-declared ``data_leaves``
        when given (after the view is built: the 2-D Gram cache still
        reads the raw rows)."""
        data = self._worker_data()
        if self._data_leaves is None:
            return data
        keep = set(self._data_leaves)
        return {k: v for k, v in data.items() if k in keep}

    def _local_state(self, state, sharded: Tuple[str, ...]):
        """The round loop's state from the caller's global state (the
        mesh keeps only its task columns of the ``sharded`` entries)."""
        return state

    def _global_entry(self, value, shard_it: bool):
        """One state entry as the caller sees it (the mesh gathers the
        task columns of a sharded entry back, uncharged)."""
        return value

    def _call_body(self, body: RoundBody, k: int, state, data):
        """Run one round of ``body`` on this backend's worker views."""
        return body(k, state, data)

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

    def _run_body(self, body: RoundBody, k: int, state, data,
                  first: bool):
        """Run round ``k`` and return its state; the charges of the
        ``first`` round this driver runs become the template, every
        later round must repeat them."""
        self._round_events = []
        self._round_data_events = []
        self._recording = True
        try:
            state = self._call_body(body, k, state, data)
        finally:
            self._recording = False
        if first:
            self._template = self._round_events
            self._data_template = self._round_data_events
        elif (self._round_events != self._template
              or self._round_data_events != self._data_template):
            raise RuntimeError(
                f"round {k} charged {self._round_events} and "
                f"{self._round_data_events} but the first round charged "
                f"{self._template} and {self._data_template}: every round "
                f"of a protocol must run the same collectives, or the "
                f"replayed ledger would be wrong")
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
        ``sharded`` names the entries that live on the workers, split
        along their last axis (task columns) on the mesh; the rest is
        replicated master state.  Returned and recorded state is always
        global, on every rank.  ``data_leaves`` names the worker-data
        leaves the body reads (None = all).  Each round runs ``body``
        once; the charges of round 0 are the per-round template,
        replayed into ``self.comm`` after every round (see the module
        docstring).  ``record`` snapshots state entries on their
        cadences.  ``scan`` is accepted for parity with the reference
        and changes nothing.  With a checkpointer attached (``_ckpt``)
        the same rounds run in segments whose carry is persisted
        (:meth:`~repro_torch.runtime.recovery.SolveCheckpointer.drive`).
        """
        self._claim()
        self._template = []
        self._data_template = []
        self._data_leaves = None if data_leaves is None else \
            tuple(data_leaves)
        sharded = tuple(sharded)
        records = self._as_records(record)
        if self._ckpt is not None:
            return self._ckpt.drive(self, rounds, body, state, sharded,
                                    records, count_rounds)
        data = self._round_data()
        state = self._local_state(state, sharded)
        snap_sets = [set(r.snap_rounds(rounds)) for r in records]
        for t in range(rounds):
            state = self._run_body(body, t, state, data, first=t == 0)
            self._replay_round(count_rounds)
            for r, sset in zip(records, snap_sets):
                if t in sset:
                    r.sink.record(t + 1, self._global_entry(
                        state[r.key], r.key in sharded))
        return {k: self._global_entry(v, k in sharded)
                for k, v in state.items()}

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

    ``backend``: "sim" | "mesh".  ``data_shards > 1`` shards each task's
    rows over that many ranks (mesh) or emulated shards (sim) along a
    second ``data_axis``.  ``mesh`` may be a prebuilt 1-D or 2-D
    ``DeviceMesh``; when omitted one is built over the whole process
    group (``runtime.mesh.task_mesh`` / ``task_data_mesh``) on the
    problem's device type.
    """
    if backend == "sim":
        from .sim import SimRuntime
        return SimRuntime(prob, data_shards=data_shards)
    if backend == "mesh":
        from .mesh import MeshRuntime
        return MeshRuntime(prob, mesh=mesh, axis=axis, data_axis=data_axis,
                           data_shards=data_shards)
    raise ValueError(f"unknown backend {backend!r}; have 'sim', 'mesh'")
