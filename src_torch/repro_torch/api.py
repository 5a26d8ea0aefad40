"""The front door: ``repro_torch.solve(prob, method=..., backend=...)``.

Port of ``repro.api.solve``.  One call signature for every ported
solver, on the simulated cluster or the ``torch.distributed`` mesh,
returning an
:class:`~repro_torch.core.methods.base.MTLResult`.  The result is also
the hand-off to the serving half::

    prob = MTLProblem.make(Xs, ys, "squared", gram=False)   # on the card
    res = repro_torch.solve(prob, method="proxgd", rounds=50, lam=0.01)
    model = res.factorize(rank=prob.r)        # (U, s, V) on the card
    server = MTLServer(model)                 # mtl_score kernel per wave

A solve with ``ckpt_dir=`` survives preemption: ``resume(ckpt_dir)``
finishes it bit-identically; one with ``verify="static"`` first holds a
twin's collectives to its ledger (:mod:`repro_torch.analysis`).
"""
from __future__ import annotations

from typing import Optional

from ._device import DeviceLike, resolve_device
from .obs.tracing import trace_span
from .runtime.base import ProtocolRuntime, make_runtime


def solve(prob, method: str = "dgsp", backend: str = "sim", *,
          mesh=None, axis: str = "tasks", data_shards: int = 1,
          data_axis: str = "data", rounds: Optional[int] = None,
          scan: Optional[bool] = None, sv_engine: Optional[str] = None,
          batch_size: Optional[int] = None,
          local_steps: Optional[int] = None, batch_seed: int = 0,
          runtime: Optional[ProtocolRuntime] = None,
          verify: Optional[str] = None,
          checkpoint_every: Optional[int] = None,
          ckpt_dir: Optional[str] = None,
          ckpt_keep: Optional[int] = 3,
          metrics: bool = False, device: DeviceLike = None, **hp):
    """Run one registered solver on the simulated cluster
    (``backend="sim"``) or the mesh (``backend="mesh"``).

    The reference's parameters keep their meaning.  ``backend="mesh"``
    runs SPMD: every rank of the process group calls ``solve`` with the
    same problem and arguments and gets the same global result.
    ``mesh`` is a ``DeviceMesh`` over ``axis`` (and ``data_axis``), or
    None for one over the whole group (``runtime.mesh.task_mesh`` /
    ``task_data_mesh``); ``data_shards > 1`` splits each task's rows
    over that many ranks, or emulated shards under sim.  ``batch_size`` /
    ``local_steps`` / ``batch_seed`` run the stochastic worker path of a
    gradient-served solver (``STOCHASTIC_SOLVERS``) on the reference's
    seeded draws; ``batch_size == n`` with ``local_steps == 1`` is the
    full-batch solve.  ``scan`` is accepted and changes nothing: both
    drivers are one eager loop.

    ``verify="static"`` first runs a twin of the configuration for at
    most ``analysis.verify.VERIFY_ROUNDS`` rounds (result thrown away)
    and holds the c10d collectives each round issues to the ledger that
    charged them (:func:`repro_torch.analysis.verify_static`); a finding
    raises :class:`~repro_torch.analysis.AnalysisError` before the real
    solve runs, and a verified result carries
    ``extras["static_verify"] == "ok"``.  It takes the declarative
    ``backend``/``mesh`` arguments, not ``runtime=``.

    ``ckpt_dir`` / ``checkpoint_every`` / ``ckpt_keep`` make the solve
    preemption-safe (:mod:`repro_torch.runtime.recovery`): the rounds run
    in ``checkpoint_every``-round segments (default
    ``recovery.DEFAULT_SEGMENT``) whose whole carry is saved to the
    store after each one, keeping the newest ``ckpt_keep`` (None: all).
    A killed solve restarts through :func:`resume` (or the same
    ``solve`` call, which picks up the newest intact segment) and ends
    with ``W``, iterates, ledger and collective floats bit-identical to
    an uninterrupted run; ``result.extras["checkpoint"]`` holds the
    segment bookkeeping.  ``metrics=True`` records per-round device
    metrics (:mod:`repro_torch.obs.device`) into
    ``result.extras["metrics"]``, leaving ``W`` and the ledger
    bit-identical to ``metrics=False``.

    ``device`` is where the solve runs, the card by default (raising
    without one); ``prob`` must already lie there ("cuda" without an
    index accepts any card).

    ``result.extras`` carries ``loss`` (so ``res.factorize()`` builds
    the serving artifact with the right math), ``backend``,
    ``data_shards`` and the two collective-float counters (0 under sim;
    ``collective_floats_per_chip`` is the ledger's worker->master floats
    times tasks per rank on the mesh, and the data counter is > 0 on a
    2-D mesh).
    """
    from .core.methods import get_solver

    dev = resolve_device(device)
    if prob.device.type != dev.type or dev.index not in (None,
                                                         prob.device.index):
        raise ValueError(f"the problem lies on {prob.device}, the solve was "
                         f"asked to run on {dev}; build the problem there "
                         f"(MTLProblem.make(..., device=...))")
    if batch_size is not None or local_steps is not None:
        from .core.methods.base import STOCHASTIC_SOLVERS
        if method not in STOCHASTIC_SOLVERS:
            raise ValueError(
                f"batch_size/local_steps need a gradient-served solver "
                f"{STOCHASTIC_SOLVERS}; {method!r} is full-batch only")
        hp["batch_size"] = batch_size
        hp["local_steps"] = local_steps
        hp["batch_seed"] = batch_seed
    if metrics:
        # set before the verify / checkpoint blocks, so the twin runs the
        # instrumented program and a resumed solve the same configuration
        hp["metrics"] = True
    if verify is not None:
        if verify != "static":
            raise ValueError(f"unknown verify mode {verify!r}; "
                             f"have 'static'")
        if runtime is not None:
            raise ValueError("verify='static' needs the declarative "
                             "backend/mesh arguments, not runtime=")
        from .analysis import verify_static
        vhp = dict(hp)
        if rounds is not None:
            vhp["rounds"] = rounds
        if sv_engine is not None:
            vhp["sv_engine"] = sv_engine
        verify_static(prob, method, backend=backend, mesh=mesh, axis=axis,
                      data_shards=data_shards, data_axis=data_axis,
                      scan=scan, **vhp)
    if runtime is None:
        runtime = make_runtime(backend, prob, mesh=mesh, axis=axis,
                               data_axis=data_axis, data_shards=data_shards)
    if rounds is not None:
        hp["rounds"] = rounds
    if scan is not None:
        hp["scan"] = scan
    if sv_engine is not None:
        hp["sv_engine"] = sv_engine
    ckpt = None
    if ckpt_dir is not None or checkpoint_every is not None:
        if ckpt_dir is None:
            raise ValueError("checkpoint_every needs ckpt_dir= (where "
                             "the solve store lives)")
        from .runtime.recovery import (DEFAULT_SEGMENT, SolveCheckpointer,
                                       write_store)
        every = DEFAULT_SEGMENT if checkpoint_every is None \
            else checkpoint_every
        config = {"method": method, "backend": backend, "axis": axis,
                  "data_axis": data_axis, "data_shards": data_shards,
                  "checkpoint_every": every, "ckpt_keep": ckpt_keep,
                  "hp": hp}
        write_store(ckpt_dir, prob, config)
        ckpt = SolveCheckpointer(ckpt_dir, every=every, keep=ckpt_keep)
        ckpt.load_resume()      # nothing to load in a fresh store
        runtime._ckpt = ckpt
    with trace_span("solve", method=method, backend=runtime.name,
                    data_shards=runtime.data_shards, metrics=bool(metrics)):
        res = get_solver(method)(prob, runtime=runtime, **hp)
    # stamp the trained loss so res.factorize() builds the serving
    # artifact with the right prediction/onboarding math by default
    res.extras.setdefault("loss", prob.loss.name)
    res.extras["backend"] = runtime.name
    res.extras["data_shards"] = runtime.data_shards
    res.extras["collective_floats_per_chip"] = \
        runtime.collective_floats_per_chip
    res.extras["data_collective_floats_per_chip"] = \
        runtime.data_collective_floats_per_chip
    if verify is not None:
        res.extras["static_verify"] = "ok"
    if ckpt is not None:
        res.extras["checkpoint"] = dict(ckpt.info)
    return res


def resume(ckpt_dir: str, *, mesh=None, device: DeviceLike = None):
    """Restart a checkpointed solve from its store: the one-argument
    recovery front door (:func:`repro_torch.runtime.recovery.resume`),
    on ``device`` (default: the card)."""
    from .runtime.recovery import resume as _resume
    return _resume(ckpt_dir, mesh=mesh, device=device)
