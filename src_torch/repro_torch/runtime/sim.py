"""Simulated-cluster backend: one process plays all m machines.

Port of ``repro.runtime.sim``.  The worker view holds every task,
per-task work is batched over the full task axis (the solvers'
``torch.func.vmap`` and batched ops) and the tasks-axis collectives are
identities that only charge the ledger.

``data_shards > 1`` emulates the 2-D ``("tasks", "data")`` layout on one
device.  Each task's rows are cut into ``data_shards`` contiguous blocks
(shard d holds rows ``[d n/D, (d+1) n/D)``, the mesh's blocks) and the
round body runs once per shard, each copy on its own thread
(:class:`_Lockstep`).  The copies take turns: one runs until it reaches
a data-axis collective, then hands the turn on; the last to arrive
reduces every shard's operand in shard order and all of them go on
with the result.  Only one copy runs at any time, so the emulation is
as deterministic as one thread, and every solver body is the same code
the mesh runs — the reference vmaps the body over a named axis instead,
which ``torch.func.vmap`` cannot reduce across.  The master's work is
repeated by every copy on equal inputs; ``run_rounds`` keeps shard 0's
state.  The emulation moves no bytes: ``data_collective_floats_per_chip``
stays 0, as ``collective_floats_per_chip`` does.
"""
from __future__ import annotations

import functools
import threading

import torch

from .base import SAMPLE_AXIS_LEAVES, ProtocolRuntime


class _Aborted(Exception):
    """Raised in a shard's thread when another shard failed."""


class _Lockstep:
    """Run ``D`` copies of a function, one per data shard, on threads
    that take turns; :meth:`meet` is their data-axis collective."""

    def __init__(self, shards: int):
        self.D = shards
        self._cv = threading.Condition()
        self._turn = 0
        self._gen = 0
        self._ops = [None] * shards
        self._out = None
        self._err = None

    def _wait(self, pred) -> None:
        self._cv.wait_for(lambda: self._err is not None or pred())
        if self._err is not None:
            raise _Aborted()

    def _arrive(self, d: int, kind, x, combine=None):
        """Shard ``d`` reached the collective ``kind`` (``None`` when it
        returned): the last shard to arrive checks that every shard is
        at the same point and combines their operands."""
        self._ops[d] = (kind, x)
        if d < self.D - 1:                # hand the turn to the next shard
            self._turn = d + 1
            self._cv.notify_all()
            return
        kinds = {op[0] for op in self._ops}
        if len(kinds) != 1:
            raise RuntimeError(f"the data shards of one round reached "
                               f"different collectives: "
                               f"{sorted(map(str, kinds))}")
        if kind is not None:
            # every shard gets its own result, made here under the lock,
            # so that no shard sees another's later in-place writes
            out = combine([op[1] for op in self._ops])
            self._out = [out] + [out.clone() for _ in range(self.D - 1)]
            self._gen += 1
            self._turn = 0
            self._cv.notify_all()

    def meet(self, d: int, kind: str, x, combine):
        """Shard ``d``'s side of one data-axis collective: ``combine``
        maps the shards' operands, in shard order, to the result every
        shard receives (each its own tensor)."""
        with self._cv:
            gen = self._gen
            self._arrive(d, kind, x, combine)
            self._wait(lambda: self._gen != gen and self._turn == d)
            return self._out[d]

    def run(self, fn):
        """``[fn(0), ..., fn(D-1)]``, each on its own thread in turn."""
        results = [None] * self.D
        grad = torch.is_grad_enabled()
        # a new thread has no current CUDA context: give it the caller's
        cuda = (torch.cuda.current_device() if torch.cuda.is_initialized()
                else None)

        def worker(d):
            try:
                with self._cv:
                    self._wait(lambda: self._turn == d)
                if cuda is not None:
                    torch.cuda.set_device(cuda)
                with torch.set_grad_enabled(grad):
                    results[d] = fn(d)
                with self._cv:
                    self._arrive(d, None, None)
            except _Aborted:
                pass
            except BaseException as e:            # noqa: BLE001
                with self._cv:
                    if self._err is None:
                        self._err = e
                    self._cv.notify_all()

        threads = [threading.Thread(target=worker, args=(d,),
                                    name=f"data-shard-{d}", daemon=True)
                   for d in range(self.D)]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        if self._err is not None:
            raise self._err
        return results


class SimRuntime(ProtocolRuntime):
    name = "sim"

    def __init__(self, prob, data_shards: int = 1):
        super().__init__(prob)
        if data_shards < 1 or prob.n % data_shards:
            raise ValueError(f"n={prob.n} samples per task must be "
                             f"divisible by data_shards={data_shards}")
        self.data_shards = int(data_shards)
        self._shard = threading.local()
        self._lockstep = None

    @property
    def local_tasks(self) -> int:
        return self.prob.m

    def data_index(self) -> int:
        return getattr(self._shard, "index", 0)

    def _records_here(self) -> bool:
        return self.data_index() == 0

    def local_slice(self, x, axis: int = -1):
        return x

    # The gathers hand the master a contiguous matrix, as the mesh's
    # all-gather does: the master's products then take the same path on
    # both backends, so the two agree bit for bit.
    def gather_columns(self, x, note: str = ""):
        # (d, m) already global; ledger: 1 d-vector per machine.
        self._charge("worker->master", 1, x.shape[0], note, wire=0)
        return x.contiguous()

    def gather_tasks(self, x, note: str = ""):
        vectors, dim = self._payload_vectors(x)
        self._charge("worker->master", vectors, dim, note, wire=0)
        return x.contiguous()

    def sum_tasks(self, x, note: str = ""):
        vectors, dim = self._payload_vectors(x)
        self._charge("worker->master", vectors, dim, note, wire=0)
        return torch.sum(x, dim=0)

    # -- data axis: the emulation's shards meet in turn ------------------
    def _psum_data(self, x):
        return self._lockstep.meet(self.data_index(), "psum", x,
                                   functools.partial(functools.reduce,
                                                     torch.add))

    def _gather_samples(self, x, axis):
        return self._lockstep.meet(self.data_index(), "all_gather", x,
                                   lambda xs: torch.cat(xs, dim=axis))

    # ------------------------------------------------------------------
    # worker data: the shard-summed Gram cache, and one view per shard
    # ------------------------------------------------------------------
    def _worker_data(self):
        data = self.prob.worker_data()
        if self.data_shards > 1 and "gram_A" in data:
            # the Gram cache as the 2-D layout builds it: a sum of
            # per-shard partial Grams (the mesh's all-reduce), which
            # agrees with the monolithic statistics to float rounding
            from ..core.worker_ops import gram_stats
            data["gram_A"], data["gram_b"] = gram_stats(
                data["Xs"], data["ys"], data_shards=self.data_shards)
        return data

    def _round_data(self):
        data = super()._round_data()
        D = self.data_shards
        if D == 1:
            return data
        return [{name: v.chunk(D, dim=1)[d].contiguous()
                 if name in SAMPLE_AXIS_LEAVES else v
                 for name, v in data.items()} for d in range(D)]

    def _call_body(self, body, k, state, data):
        if self.data_shards == 1:
            return body(k, state, data)

        def shard(d):
            self._shard.index = d
            return body(k, state, data[d])

        self._lockstep = _Lockstep(self.data_shards)
        try:
            # every shard's state is the same by construction (reduced
            # statistics, the same master work); shard 0's is THE value
            return self._lockstep.run(shard)[0]
        finally:
            self._lockstep = None
