"""Closed train -> serve loop: a streaming background re-solver (§13).

Port of ``repro.train.streaming``.  The offline half of the system
solves a FIXED problem; real deployments keep collecting samples.  This
module closes the loop on the factored serving stack
(:mod:`repro_torch.serve.mtl`):

* :class:`SampleStream` — a seeded stream of fresh per-task samples from
  the ``W*`` generative model of :mod:`repro_torch.data.synthetic`,
  drawn through the port's threefry (:mod:`repro_torch.core.prng`), so a
  stream gives the reference's draws under the same seed and tick.
* :class:`ReservoirBuffer` — per-task fixed-capacity reservoirs
  (algorithm R) over the stream, on the host, with the reference's
  numpy generator (so the same slots are replaced).  Capacity stays at
  the initial problem's ``n``, so every rebuilt problem has the same
  shapes.
* :class:`StreamingResolver` — ingest -> re-solve -> publish.  The
  re-solve runs the stochastic worker path (``repro_torch.solve(...,
  batch_size=, local_steps=)``), warm-started from the previous
  result's predictors (``init_W``) and spectral-engine carry
  (``sv_carry``).  The refreshed predictors are factorized
  (``MTLResult.factorize``), saved through the atomic model store
  (``FactoredModel.save``) and picked up by the live
  :class:`~repro_torch.serve.mtl.MTLServer` through ``maybe_reload``;
  the server's readers never block on a refresh.

Staleness: for every publish, ``staleness_oldest`` is ``publish time -
earliest arrival`` over the samples ingested since the previous publish
(the age of the oldest sample the served model had not yet seen);
``staleness_newest`` is the same against the latest arrival.  Arrival
times are host ``time.monotonic`` stamps taken at ``ingest``; the
publish time is stamped after ``maybe_reload`` returns.  Both land in
gauges of :mod:`repro_torch.obs.metrics`.

Everything here is host orchestration: the solver and the server run on
the problem's device (the card unless the caller asks for the CPU).
"""
from __future__ import annotations

import threading
import time
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from .._device import DeviceLike, resolve_device
from ..core import prng
from ..core.methods.base import STOCHASTIC_SOLVERS, MTLProblem
from ..obs.metrics import default_registry
from ..obs.tracing import trace_span

# solvers whose signatures accept a predictor warm start (init_W) /
# a spectral-engine carry (sv_carry): the prox family re-enters from
# the previous published iterate; ADMM re-uses the engine basis only
# (its W/Z/Q splitting has no single warm iterate).
WARM_INIT_SOLVERS = ("accproxgd", "proxgd")
WARM_SV_SOLVERS = ("accproxgd", "admm", "proxgd")


def _host(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


class SampleStream:
    """Seeded per-task sample stream from the ``W*`` generative model.

    Each :meth:`draw` returns ``count`` fresh rows per task, keyed on
    ``(seed, draw index)``: two streams with the same seed replay the
    same sample sequence.  The draws run on ``device`` (default: the
    card).
    """

    def __init__(self, Wstar, Sigma, noise: float = 1.0,
                 task: str = "regression", seed: int = 0,
                 device: DeviceLike = None):
        dev = resolve_device(device)
        self.Wstar = torch.as_tensor(Wstar, device=dev).to(torch.float32)
        self.p, self.m = self.Wstar.shape
        Sigma = torch.as_tensor(Sigma, device=dev).to(torch.float32)
        self.chol = torch.linalg.cholesky(
            Sigma + 1e-9 * torch.eye(self.p, dtype=Sigma.dtype, device=dev))
        self.noise = float(noise)
        if task not in ("regression", "classification"):
            raise ValueError(f"unknown task {task!r}")
        self.task = task
        self.seed = int(seed)
        self.device = dev
        self._tick = 0

    def draw(self, count: int) -> Tuple[torch.Tensor, torch.Tensor]:
        """Next ``count`` samples per task: ``(m, count, p), (m, count)``."""
        key = prng.fold_in(prng.PRNGKey(self.seed, device=self.device),
                           self._tick)
        self._tick += 1
        kx, ky = prng.split(key)
        Z = prng.normal(kx, (self.m, int(count), self.p), self.Wstar.dtype)
        Xs = Z @ self.chol.T
        margins = torch.einsum("mnp,pm->mn", Xs, self.Wstar)
        if self.task == "regression":
            ys = margins + self.noise * prng.normal(ky, tuple(margins.shape))
        else:
            prob1 = torch.sigmoid(margins)
            ys = torch.where(prng.uniform(ky, tuple(margins.shape)) < prob1,
                             1.0, -1.0)
        return Xs, ys


class ReservoirBuffer:
    """Per-task algorithm-R reservoirs over the sample stream.

    Capacity is fixed at construction (the initial problem's ``n``):
    each new sample replaces a uniformly random slot with probability
    ``capacity / seen``, so every sample ever streamed is in the
    reservoir with equal probability.  The buffers and the slot draws
    (a seeded numpy generator) live on the host; a refresh moves the
    buffers to the problem's device.
    """

    def __init__(self, Xs, ys, seed: int = 0):
        self.Xs = np.array(_host(Xs))        # (m, cap, p): owned, mutable
        self.ys = np.array(_host(ys))        # (m, cap)
        self.m, self.capacity, self.p = self.Xs.shape
        self.seen = int(self.capacity)       # per task; fills start full
        self._rng = np.random.default_rng(int(seed))

    def add(self, Xs_new, ys_new) -> int:
        """Fold a fresh draw ``(m, t, p), (m, t)`` into the reservoirs.

        Returns the number of rows (per task) that landed in a
        reservoir slot this call."""
        Xs_new, ys_new = _host(Xs_new), _host(ys_new)
        if Xs_new.shape[0] != self.m or Xs_new.shape[2] != self.p:
            raise ValueError(f"stream shape {Xs_new.shape} does not match "
                             f"buffer (m={self.m}, p={self.p})")
        kept = 0
        for i in range(Xs_new.shape[1]):
            self.seen += 1
            # one shared slot decision per arrival keeps every task's
            # reservoir a uniform sample of ITS stream (the streams are
            # task-aligned: row i arrived for all tasks)
            j = int(self._rng.integers(self.seen))
            if j < self.capacity:
                self.Xs[:, j] = Xs_new[:, i]
                self.ys[:, j] = ys_new[:, i]
                kept += 1
        return kept

    def problem(self, template: MTLProblem) -> MTLProblem:
        """An :class:`MTLProblem` from the current reservoirs on the
        template's device, with its loss and structural constants."""
        return MTLProblem.make(
            self.Xs, self.ys, loss_name=template.loss.name,
            gram=template.gram_A is not None, device=template.device,
            A=template.A, r=template.r, l2=template.l2)


class StreamingResolver:
    """The closed loop: ingest samples -> re-solve -> publish.

    One :meth:`step` (or one ``ingest`` + ``refresh`` pair) runs the
    whole cycle synchronously; :meth:`start` runs the same cycle in a
    daemon thread for live serving.  The served
    :class:`~repro_torch.serve.mtl.MTLServer` is only touched through
    its public ``maybe_reload``.
    """

    def __init__(self, prob: MTLProblem, server, store_dir: str, *,
                 method: str = "proxgd", rank: Optional[int] = None,
                 rounds: int = 8, batch_size: Optional[int] = None,
                 local_steps: Optional[int] = None, batch_seed: int = 0,
                 warm_start: bool = True, warm_from=None,
                 backend: str = "sim", buffer_seed: int = 0,
                 solver_hp: Optional[Dict] = None, registry=None):
        if method not in STOCHASTIC_SOLVERS:
            raise ValueError(
                f"streaming re-solves run the stochastic worker path; "
                f"method must be one of {STOCHASTIC_SOLVERS}, "
                f"got {method!r}")
        self.template = prob
        self.server = server
        self.store_dir = str(store_dir)
        self.method = method
        self.rank = int(rank if rank is not None else prob.r)
        self.rounds = int(rounds)
        self.batch_size = batch_size
        self.local_steps = local_steps
        self.batch_seed = int(batch_seed)
        self.warm_start = bool(warm_start)
        self.backend = backend
        self.solver_hp = dict(solver_hp or {})
        self.buffer = ReservoirBuffer(prob.Xs, prob.ys, seed=buffer_seed)
        # warm-start carry: the previous solve's predictors and engine
        # carry; ``warm_from`` (an MTLResult, e.g. the offline solve)
        # seeds it so the FIRST refresh is warm too
        self._prev_W = None if warm_from is None else warm_from.W
        self._prev_sv = None if warm_from is None \
            else warm_from.extras.get("sv_carry")
        self._refresh_idx = 0
        # arrival stamps (time.monotonic) of draws not yet published
        self._pending_arrivals: List[float] = []
        self.history: List[Dict] = []     # one report dict per refresh
        self._last_result = None
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self.error: Optional[BaseException] = None
        # the SLO gauges land in the registry the server reports its
        # latency into, so one snapshot carries the whole loop
        self.registry = default_registry() if registry is None else registry
        self._g_stale_old = self.registry.gauge(
            "streaming_staleness_oldest_seconds")
        self._g_stale_new = self.registry.gauge(
            "streaming_staleness_newest_seconds")
        self._g_solve = self.registry.gauge("streaming_solve_seconds")
        self._c_refresh = self.registry.counter("streaming_refreshes_total")

    # -- the loop body -------------------------------------------------
    def ingest(self, Xs_new, ys_new,
               arrival: Optional[float] = None) -> int:
        """Fold a fresh stream draw into the reservoirs, stamping its
        arrival time for the staleness ledger."""
        self._pending_arrivals.append(
            time.monotonic() if arrival is None else float(arrival))
        return self.buffer.add(Xs_new, ys_new)

    def refresh(self) -> Dict:
        """Re-solve on the current reservoirs and publish.

        Returns the refresh report (also appended to ``history``): solve
        metadata, the published store step and served version, and the
        staleness of the samples this publish absorbed."""
        from .. import api

        prob = self.buffer.problem(self.template)
        hp = dict(self.solver_hp)
        hp.setdefault("rounds", self.rounds)
        if self.batch_size is not None:
            hp["batch_size"] = self.batch_size
        if self.local_steps is not None:
            hp["local_steps"] = self.local_steps
        if self.batch_size is not None or self.local_steps is not None:
            # a fresh sub-stream of batch draws per refresh
            hp["batch_seed"] = self.batch_seed + self._refresh_idx
        warmed = False
        if self.warm_start:
            if self._prev_W is not None and self.method in WARM_INIT_SOLVERS:
                hp["init_W"] = self._prev_W
                warmed = True
            if self._prev_sv is not None and self.method in WARM_SV_SOLVERS:
                hp["sv_carry"] = self._prev_sv
                warmed = True
        if self.method in WARM_SV_SOLVERS:
            hp["keep_sv_carry"] = True
        # durations from perf_counter; staleness on time.monotonic, the
        # clock of the arrival stamps
        t0_perf = time.perf_counter()
        with trace_span("streaming.refresh", refresh=self._refresh_idx,
                        method=self.method):
            with trace_span("streaming.solve", method=self.method,
                            rounds=self.rounds, warm=warmed):
                res = api.solve(prob, method=self.method,
                                backend=self.backend, device=prob.device,
                                **hp)
            self._prev_W = res.W
            self._prev_sv = res.extras.get("sv_carry")
            with trace_span("streaming.factorize", rank=self.rank):
                model = res.factorize(self.rank)
            with trace_span("streaming.publish", store=self.store_dir):
                step = model.save(self.store_dir)
                reloaded = self.server.maybe_reload(self.store_dir) \
                    if self.server is not None else False
        t_pub = time.monotonic()
        solve_s = time.perf_counter() - t0_perf
        arrivals, self._pending_arrivals = self._pending_arrivals, []
        report = {
            "refresh": self._refresh_idx,
            "method": self.method,
            "rounds": self.rounds,
            "warm_started": warmed,
            "samples_seen": self.buffer.seen,
            "store_step": int(step),
            "reloaded": bool(reloaded),
            "served_version": getattr(self.server, "version", None),
            "solve_s": solve_s,
            "staleness_oldest_s":
                (t_pub - min(arrivals)) if arrivals else 0.0,
            "staleness_newest_s":
                (t_pub - max(arrivals)) if arrivals else 0.0,
            "ingests_absorbed": len(arrivals),
        }
        self._g_stale_old.set(report["staleness_oldest_s"])
        self._g_stale_new.set(report["staleness_newest_s"])
        self._g_solve.set(solve_s)
        self._c_refresh.inc()
        self._refresh_idx += 1
        self.history.append(report)
        self._last_result = res
        return report

    def step(self, stream: SampleStream, count: int) -> Dict:
        """One synchronous cycle: draw -> ingest -> refresh -> publish."""
        Xs_new, ys_new = stream.draw(count)
        self.ingest(Xs_new, ys_new)
        return self.refresh()

    # -- background wrapper --------------------------------------------
    def start(self, stream: SampleStream, count: int,
              interval_s: float = 0.0,
              max_refreshes: Optional[int] = None) -> threading.Thread:
        """Run :meth:`step` cycles in a daemon thread until :meth:`stop`
        (or ``max_refreshes``).  An exception is kept in ``self.error``
        and ends the loop."""
        if self._thread is not None and self._thread.is_alive():
            raise RuntimeError("streaming resolver already running")
        self._stop.clear()

        def loop():
            try:
                while not self._stop.is_set():
                    if max_refreshes is not None \
                            and self._refresh_idx >= max_refreshes:
                        break
                    self.step(stream, count)
                    if interval_s:
                        self._stop.wait(interval_s)
            except BaseException as e:       # surfaced to the caller
                self.error = e

        self._thread = threading.Thread(
            target=loop, name="streaming-resolver", daemon=True)
        self._thread.start()
        return self._thread

    def stop(self, timeout: float = 30.0) -> None:
        """Signal the background loop to finish and join it within
        ``timeout`` seconds; raises ``TimeoutError`` if the thread is
        still running then, and re-raises any exception the loop kept."""
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout)
            if self._thread.is_alive():
                raise TimeoutError(f"the streaming resolver's thread did "
                                   f"not finish within {timeout} s")
            self._thread = None
        if self.error is not None:
            raise self.error
