"""Deterministic fault injection for the preemption-recovery path.

Port of ``repro.faults``.  A seeded :class:`FaultPlan` arms the
checkpoint store's fault hook inside a subprocess solve; the harness
(:func:`run_case`, :func:`run_cases`) kills or damages the solve store
exactly as planned, resumes through :func:`repro_torch.resume`, and
compares the recovered result bit for bit with an uninterrupted run of
the same solve.

Fault kinds (the preemption taxonomy of DESIGN.md §12):

* ``sigkill``        — SIGKILL mid-solve, right after the ``after``-th
                       segment checkpoint lands (the clean preemption).
* ``crash_rename``   — SIGKILL between the checkpoint's npz write and
                       its atomic rename: a ``*.tmp`` orphan, no
                       truncated ``step_*.npz`` ever becomes visible.
* ``corrupt``        — the newest checkpoint's bytes are flipped after
                       the kill (seeded); recovery must fall back to
                       the previous intact step.
* ``stale_manifest`` — the newest checkpoint vanishes while the store
                       manifest still points at it; recovery must roll
                       back to what verifies on disk.

Rules of the harness:

* the plan reaches a child only through the ``env=`` of its subprocess
  call, under ``REPRO_TORCH_FAULT_PLAN`` (not the reference's variable,
  so neither package's child reads the other's plan); the calling
  process's own environment is never written;
* every case works in the ``workdir`` its caller gives;
* every child runs with one intra-op thread, on ``device`` (``cpu`` or
  the card), under a time limit of at most :data:`CHILD_TIMEOUT_S`;
* the multi-process case starts its ranks on a ``file://`` store in the
  workdir (no TCP port), with a 60 s group timeout, and when one rank
  dies the harness kills the others at once, as a launcher would.

Entry points::

    python -m repro_torch.faults report --workdir DIR --device cpu
    python -m repro_torch.faults multiprocess --workdir DIR --device cpu
    repro_torch.faults.run_case("sigkill", workdir=DIR, device="cpu")

Each case runs its solves in subprocesses (baseline, faulted, resumed),
so every kill is a real process death, not an exception.
"""
from __future__ import annotations

import dataclasses
import json
import os
import signal
import subprocess
import sys
import time
from typing import Any, Dict, List, Optional

import numpy as np

KINDS = ("sigkill", "crash_rename", "corrupt", "stale_manifest")

PLAN_ENV = "REPRO_TORCH_FAULT_PLAN"
CHILD_TIMEOUT_S = 120.0        # every child process, start to exit
GROUP_TIMEOUT_S = 60.0         # every process group's collective timeout
DURABLE_WAIT_S = 10.0          # a non-writer's wait for the segment on disk

# the fault each kind plants: the firing of its event it dies on (the
# byte-level kinds die late, so that there is a segment to damage)
AFTER = {"sigkill": 2, "crash_rename": 2, "corrupt": 3, "stale_manifest": 3}


@dataclasses.dataclass
class FaultPlan:
    """One planned process death, deterministic given the plan."""
    kind: str                 # one of KINDS
    after: int = 2            # die on the after-th firing of the event
    at_event: str = ""        # override; default derived from kind
    seed: int = 0             # corruption RNG seed (corrupt kind)

    @property
    def event(self) -> str:
        if self.at_event:
            return self.at_event
        # crash_rename dies INSIDE the checkpoint write (between the npz
        # write and the rename); every other kind after a durable save
        return "pre_rename" if self.kind == "crash_rename" \
            else "segment_saved"

    def to_env(self) -> str:
        return json.dumps(dataclasses.asdict(self))


def _wait_durable(ckpt_dir: str, step: int, writer: bool,
                  timeout: float = DURABLE_WAIT_S) -> None:
    """Return once the store's MANIFEST names segment ``step`` or a later
    one (``latest >= step``).  Only rank 0 writes the store, and the
    ``segment_saved`` event fires on every rank as soon as its own save
    step returns, so a rank that does not write must wait for the writer
    before it dies, or the segment its plan counts may never land.  The
    writer returns at once.  Past ``timeout`` seconds it raises, and the
    planned death does not happen."""
    if writer:
        return
    from .runtime.recovery import MANIFEST
    path = os.path.join(ckpt_dir, MANIFEST)
    deadline = time.monotonic() + timeout
    while True:
        try:
            with open(path) as f:
                latest = json.load(f).get("latest")
        except (OSError, ValueError):
            latest = None
        if latest is not None and latest >= step:
            return
        if time.monotonic() > deadline:
            raise RuntimeError(
                f"segment {step} never became durable in {ckpt_dir} within "
                f"{timeout} s (MANIFEST latest {latest}); not killing")
        time.sleep(0.01)


def arm(plan: FaultPlan) -> None:
    """Install the plan on this process's checkpoint fault hook."""
    if plan.kind not in KINDS:
        raise ValueError(f"unknown fault kind {plan.kind!r}; have {KINDS}")
    from .runtime.recovery import is_primary
    from .train import checkpoint as ck
    count = {"n": 0}

    def hook(event: str, **info) -> None:
        if event != plan.event:
            return
        count["n"] += 1
        if count["n"] == plan.after:
            if event == "segment_saved":
                _wait_durable(info["ckpt_dir"], info["step"], is_primary())
            # a real preemption, not an exception: nothing gets to clean
            # up, flush, or finish the rename
            os.kill(os.getpid(), signal.SIGKILL)

    ck._fault_hook = hook


def arm_from_env(env_var: str = PLAN_ENV) -> Optional[FaultPlan]:
    """Arm the plan the parent passed in ``env_var``, if any."""
    raw = os.environ.get(env_var)
    if not raw:
        return None
    plan = FaultPlan(**json.loads(raw))
    arm(plan)
    return plan


def corrupt_npz(path: str, seed: int = 0, mode: str = "flip") -> None:
    """Deterministically damage a checkpoint file in place.

    ``flip`` xors 16 seeded bytes in the payload region; ``truncate``
    cuts the file to 60%.  The store's content hash or zip structure
    check must catch both, never load them silently.
    """
    with open(path, "rb") as f:
        blob = bytearray(f.read())
    rng = np.random.default_rng(seed)
    if mode == "truncate":
        blob = blob[: max(1, int(len(blob) * 0.6))]
    elif mode == "flip":
        lo, hi = len(blob) // 4, 3 * len(blob) // 4
        for i in rng.integers(lo, hi, size=16):
            blob[int(i)] ^= 0xFF
    else:
        raise ValueError(f"unknown corruption mode {mode!r}")
    with open(path, "wb") as f:
        f.write(bytes(blob))


def _newest_step(ckpt_dir: str) -> str:
    from .train import checkpoint as ck
    steps = ck.available_steps(ckpt_dir)
    if not steps:
        raise FileNotFoundError(f"no checkpoints in {ckpt_dir}")
    return os.path.join(ckpt_dir, f"step_{steps[-1]:08d}.npz")


# ----------------------------------------------------------------------
# the solves the cases run
# ----------------------------------------------------------------------
def demo_problem(device=None):
    """The harness's default problem: the reference's seeded §5 draw
    ``SimSpec(p=16, m=8, r=3, n=32)`` through the port's threefry, on
    ``device`` (default: the card)."""
    from ._device import resolve_device
    from .core import prng
    from .core.methods.base import MTLProblem
    from .data.synthetic import SimSpec, generate
    dev = resolve_device(device)
    Xs, ys, _, _ = generate(prng.PRNGKey(0, device=dev),
                            SimSpec(p=16, m=8, r=3, n=32), device=dev)
    return MTLProblem.make(Xs, ys, "squared", A=2.0, r=3, device=dev)


SOLVE_KW: Dict[str, Any] = {"method": "proxgd", "lam": 0.05, "rounds": 11,
                            "record_every": 3}
CHECKPOINT_EVERY = 3          # segments end at rounds 3, 6, 9, 11


def save_problem(path: str, prob) -> None:
    """Write a problem for the children: its arrays and constants."""
    meta = {"loss": prob.loss.name, "A": prob.A, "r": prob.r,
            "l2": prob.l2, "gram": prob.gram_A is not None}
    np.savez(path, Xs=prob.Xs.detach().cpu().numpy(),
             ys=prob.ys.detach().cpu().numpy(),
             meta=np.frombuffer(json.dumps(meta).encode(), np.uint8))


def load_problem(path: str, device=None):
    """A problem :func:`save_problem` wrote, on ``device``."""
    from .core.methods.base import MTLProblem
    with np.load(path) as d:
        meta = json.loads(d["meta"].tobytes())
        return MTLProblem.make(d["Xs"], d["ys"], meta["loss"],
                               gram=meta["gram"], A=meta["A"], r=meta["r"],
                               l2=meta["l2"], device=device)


def result_blob(res) -> Dict[str, np.ndarray]:
    """Everything bit-identity covers, as npz-able arrays."""
    ledger = json.dumps([[e.round, e.direction, e.vectors, e.dim, e.note]
                         for e in res.comm.events]).encode()
    return {
        "W": res.W.detach().cpu().numpy(),
        "iterates": np.stack([w.detach().cpu().numpy()
                              for w in res.iterates]),
        "rounds_axis": np.asarray(res.rounds_axis, np.int64),
        "ledger": np.frombuffer(ledger, np.uint8).copy(),
        "floats": np.asarray(
            [res.extras["collective_floats_per_chip"],
             res.extras["data_collective_floats_per_chip"],
             res.comm.rounds], np.int64),
    }


def blobs_equal(a, b) -> bool:
    keys = sorted(set(a) | set(b))
    return all(k in a and k in b
               and np.array_equal(np.asarray(a[k]), np.asarray(b[k]))
               for k in keys)


def _load_blob(path: str) -> Dict[str, np.ndarray]:
    with np.load(path) as d:
        return {k: d[k] for k in d.files}


# ----------------------------------------------------------------------
# subprocess plumbing
# ----------------------------------------------------------------------
def _child_env(plan: Optional[FaultPlan] = None) -> Dict[str, str]:
    """The child's environment: this process's, with the port's package
    root on PYTHONPATH, one OpenMP thread and the plan (or none)."""
    env = dict(os.environ)
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env["PYTHONPATH"] = os.pathsep.join(
        [root] + [p for p in env.get("PYTHONPATH", "").split(os.pathsep)
                  if p])
    env["OMP_NUM_THREADS"] = "1"
    if plan is not None:
        env[PLAN_ENV] = plan.to_env()
    else:
        env.pop(PLAN_ENV, None)
    return env


_DIED = (0, -signal.SIGKILL, 128 + signal.SIGKILL)


def _run_children(jobs: List[Dict[str, Any]], parallel: bool,
                  timeout: float) -> List[int]:
    """Run ``jobs`` (``args``, ``env``, ``log``, ``may_die``) as
    ``python -m repro_torch.faults`` children, all at once or one after
    another, each within ``timeout`` seconds; return their exit codes.
    A child that fails (or dies where it may not) fails the call with
    its log; every child still running then is killed."""
    if timeout > CHILD_TIMEOUT_S:
        raise ValueError(f"a child's time limit is at most "
                         f"{CHILD_TIMEOUT_S} s, not {timeout}")
    codes: List[int] = []
    batches = [jobs] if parallel else [[j] for j in jobs]
    for batch in batches:
        procs = []
        try:
            for job in batch:
                with open(job["log"], "w") as f:
                    procs.append(subprocess.Popen(
                        [sys.executable, "-m", "repro_torch.faults"]
                        + job["args"], env=job["env"], stdout=f,
                        stderr=subprocess.STDOUT))
            deadline = time.monotonic() + timeout
            for job, p in zip(batch, procs):
                try:
                    rc = p.wait(max(0.0, deadline - time.monotonic()))
                except subprocess.TimeoutExpired:
                    raise RuntimeError(
                        f"faults child ran past {timeout} s: {job['args']}"
                        f"\n{_tail(job['log'])}") from None
                ok = rc in _DIED if job.get("may_die") else rc == 0
                if not ok:
                    raise RuntimeError(
                        f"faults child failed ({rc}): {job['args']}\n"
                        f"{_tail(job['log'])}")
                codes.append(rc)
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                p.wait()
    return codes


def _tail(path: str, n: int = 3000) -> str:
    with open(path, errors="replace") as f:
        return f.read()[-n:]


def _case_name(case: Dict[str, Any]) -> str:
    return (f"{case['kind']}-{case.get('backend', 'sim')}"
            f"-d{case.get('data_shards', 1)}")


def _child_args(case: Dict[str, Any], device: str) -> List[str]:
    args = ["child", "--device", device,
            "--backend", case.get("backend", "sim"),
            "--data-shards", str(case.get("data_shards", 1)),
            "--solve", json.dumps(case.get("solve", SOLVE_KW)),
            "--every", str(case.get("every", CHECKPOINT_EVERY))]
    if case.get("problem"):
        args += ["--problem", case["problem"]]
    return args


def run_cases(cases: List[Dict[str, Any]], workdir: str, *,
              device: str = "cpu", parallel: bool = False,
              timeout: float = CHILD_TIMEOUT_S) -> List[Dict[str, Any]]:
    """Fault each case's solve, resume it once, and compare with its
    uninterrupted baseline.

    A case is a dict: ``kind`` (one of :data:`KINDS`), and optionally
    ``backend`` ("sim"), ``data_shards`` (1), ``problem`` (an npz from
    :func:`save_problem`; default :func:`demo_problem`), ``solve`` (the
    solve's arguments; default :data:`SOLVE_KW`), ``every``
    (:data:`CHECKPOINT_EVERY`) and ``dir`` (its directory under
    ``workdir``).  Baselines that the cases share run once.  With
    ``parallel`` the baselines and faulted solves start together, then
    the resumes.  Returns one report a case: ``recovered`` is True when
    ONE resume after the planned fault reproduced the uninterrupted
    result exactly; ``launches`` gives each side's kernel launches.
    """
    from .obs.tracing import emit_event
    for case in cases:
        if case["kind"] not in KINDS:
            raise ValueError(f"unknown fault kind {case['kind']!r}; "
                             f"have {KINDS}")
    os.makedirs(workdir, exist_ok=True)
    work = []
    jobs: List[Dict[str, Any]] = []
    baselines: Dict[str, str] = {}
    for case in cases:
        d = os.path.join(workdir, case.get("dir", _case_name(case)))
        os.makedirs(d, exist_ok=True)
        args = _child_args(case, device)
        key = json.dumps(args)
        if key not in baselines:
            base = os.path.join(workdir, f"base{len(baselines)}.npz")
            baselines[key] = base
            jobs.append({"args": args + ["--out", base], "env": _child_env(),
                         "log": base + ".log"})
        plan = FaultPlan(kind=case["kind"], after=AFTER[case["kind"]])
        store = os.path.join(d, "store")
        jobs.append({"args": args + ["--ckpt-dir", store],
                     "env": _child_env(plan), "may_die": True,
                     "log": os.path.join(d, "faulted.log")})
        work.append((case, d, store, plan, baselines[key], args))
    codes = iter(_run_children(jobs, parallel, timeout))
    killed = {}
    for job in jobs:
        rc = next(codes)
        if job.get("may_die"):
            killed[job["log"]] = rc
    resumes = []
    for case, d, store, plan, _, args in work:
        rc = killed[os.path.join(d, "faulted.log")]
        emit_event("faults.injected", kind=case["kind"],
                   backend=case.get("backend", "sim"), after=plan.after,
                   exit_code=rc, ckpt_dir=store)
        # post-mortem store damage for the byte-level kinds
        if case["kind"] == "corrupt":
            corrupt_npz(_newest_step(store), seed=plan.seed)
            emit_event("faults.store_damaged", kind=case["kind"],
                       ckpt_dir=store)
        elif case["kind"] == "stale_manifest":
            os.remove(_newest_step(store))
            emit_event("faults.store_damaged", kind=case["kind"],
                       ckpt_dir=store)
        out = os.path.join(d, "resumed.npz")
        resumes.append({"args": ["child", "--device", device, "--resume",
                                 "--ckpt-dir", store, "--out", out],
                        "env": _child_env(), "log": out + ".log"})
    _run_children(resumes, parallel, timeout)
    reports = []
    for (case, d, store, plan, base, _), job in zip(work, resumes):
        out = job["args"][-1]
        identical = blobs_equal(_load_blob(base), _load_blob(out))
        rc = killed[os.path.join(d, "faulted.log")]
        with open(base + ".json") as f:
            base_info = json.load(f)
        with open(out + ".json") as f:
            res_info = json.load(f)
        report = {"kind": case["kind"],
                  "backend": case.get("backend", "sim"),
                  "data_shards": case.get("data_shards", 1),
                  "device": device, "killed": rc != 0, "exit_code": rc,
                  "bit_identical": identical,
                  "recovered": bool(rc != 0 and identical),
                  "rounds": base_info["rounds"],
                  "resumed_from": res_info["checkpoint"]["resumed_from"],
                  "launches": {"baseline": base_info["launches"],
                               "resumed": res_info["launches"]},
                  "seconds": {"baseline": base_info["seconds"],
                              "resumed": res_info["seconds"]},
                  "store": store}
        emit_event("faults.case_done", **report)
        reports.append(report)
    return reports


def run_case(kind: str, backend: str = "sim", data_shards: int = 1, *,
             workdir: str, device: str = "cpu",
             timeout: float = CHILD_TIMEOUT_S, **case) -> Dict[str, Any]:
    """One case of :func:`run_cases`, its store at ``workdir/store``."""
    return run_cases([dict(case, kind=kind, backend=backend,
                           data_shards=data_shards, dir="")], workdir,
                     device=device, timeout=timeout)[0]


# ----------------------------------------------------------------------
# the multi-process case: kill one rank of a mesh solve, resume
# ----------------------------------------------------------------------
def _mp_launch(workdir: str, tag: str, nprocs: int, extra: List[str],
               device: str, fault_rank: Optional[int] = None,
               plan: Optional[FaultPlan] = None,
               timeout: float = CHILD_TIMEOUT_S) -> List[int]:
    """Start ``nprocs`` ranks of one mesh solve on a fresh ``file://``
    store and wait for them.  When a rank dies the others are killed at
    once (they would wait in a collective for a peer that is gone).
    Without a planned fault every rank must exit 0."""
    init = os.path.join(workdir, f"{tag}.rendezvous")
    procs, logs = [], []
    for rank in range(nprocs):
        log = os.path.join(workdir, f"{tag}.rank{rank}.log")
        with open(log, "w") as f:
            procs.append(subprocess.Popen(
                [sys.executable, "-m", "repro_torch.faults", "mp-child",
                 "--rank", str(rank), "--nprocs", str(nprocs),
                 "--init", "file://" + init, "--device", device] + extra,
                env=_child_env(plan if rank == fault_rank else None),
                stdout=f, stderr=subprocess.STDOUT))
        logs.append(log)
    deadline = time.monotonic() + timeout
    try:
        while any(p.poll() is None for p in procs):
            if any(p.poll() not in (None, 0) for p in procs):
                break                        # a rank died: reap the rest
            if time.monotonic() > deadline:
                raise RuntimeError(f"the {tag} ranks ran past {timeout} s")
            time.sleep(0.05)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
            p.wait()
    codes = [p.returncode for p in procs]
    if fault_rank is None and any(codes):
        raise RuntimeError(
            f"{tag} ranks failed: {codes}\n" + "\n".join(
                f"--- rank {i}\n{_tail(log)}" for i, log in enumerate(logs)))
    return codes


def run_multiprocess_case(workdir: str, nprocs: int = 2,
                          device: str = "cpu") -> Dict[str, Any]:
    """A mesh solve over ``nprocs`` ranks is killed on its last rank
    after the second durable segment, every other rank is killed at
    once, and a fresh launch resumes the store to a result
    bit-identical to the uninterrupted launch's."""
    os.makedirs(workdir, exist_ok=True)
    store = os.path.join(workdir, "store")
    base = os.path.join(workdir, "mp_base.npz")
    out = os.path.join(workdir, "mp_resumed.npz")
    _mp_launch(workdir, "base", nprocs, ["--out", base], device)
    codes = _mp_launch(workdir, "faulted", nprocs, ["--ckpt-dir", store],
                       device, fault_rank=nprocs - 1,
                       plan=FaultPlan("sigkill", after=2))
    _mp_launch(workdir, "resumed", nprocs,
               ["--ckpt-dir", store, "--resume", "--out", out], device)
    identical = blobs_equal(_load_blob(base), _load_blob(out))
    killed = any(c != 0 for c in codes)
    with open(out + ".json") as f:
        info = json.load(f)
    return {"kind": "mp_sigkill", "nprocs": nprocs, "device": device,
            "killed": killed, "exit_codes": codes,
            "bit_identical": identical,
            "resumed_from": info["checkpoint"]["resumed_from"],
            "recovered": bool(killed and identical)}


# ----------------------------------------------------------------------
# the children
# ----------------------------------------------------------------------
def _launches() -> Dict[str, int]:
    from .kernels.mtl_grad import ops as grad_ops
    from .kernels.prox_step import ops as prox_ops
    return {"mtl_grad": grad_ops.task_gradients.launches,
            "prox_step": prox_ops.prox_step.launches}


def _child_setup(device: str):
    import torch
    torch.set_num_threads(1)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    arm_from_env()
    from ._device import resolve_device
    return resolve_device(device)


def _write_out(path: str, res, seconds: float) -> None:
    np.savez(path, **result_blob(res))
    with open(path + ".json", "w") as f:
        json.dump({"launches": _launches(), "seconds": seconds,
                   "rounds": res.comm.rounds,
                   "checkpoint": res.extras.get("checkpoint")}, f)


def _cmd_child(args) -> None:
    dev = _child_setup(args.device)
    from .api import resume, solve
    t0 = time.perf_counter()
    if args.resume:
        res = resume(args.ckpt_dir, device=dev)
    else:
        prob = (load_problem(args.problem, dev) if args.problem
                else demo_problem(dev))
        res = solve(prob, backend=args.backend, data_shards=args.data_shards,
                    ckpt_dir=args.ckpt_dir,
                    checkpoint_every=args.every if args.ckpt_dir else None,
                    device=dev, **json.loads(args.solve))
    if dev.type == "cuda":
        import torch
        torch.cuda.synchronize()
    if args.out:
        _write_out(args.out, res, time.perf_counter() - t0)


def _cmd_mp_child(args) -> None:
    dev = _child_setup(args.device)
    import torch.distributed as dist
    from .api import resume, solve
    from .runtime.mesh import task_mesh
    from .runtime.recovery import init_cluster
    init_cluster(args.init, args.nprocs, args.rank, device=dev,
                 timeout_s=GROUP_TIMEOUT_S)
    try:
        mesh = task_mesh(device=dev.type)
        t0 = time.perf_counter()
        if args.resume:
            res = resume(args.ckpt_dir, mesh=mesh, device=dev)
        else:
            res = solve(demo_problem(dev), backend="mesh", mesh=mesh,
                        ckpt_dir=args.ckpt_dir,
                        checkpoint_every=(CHECKPOINT_EVERY if args.ckpt_dir
                                          else None),
                        device=dev, **SOLVE_KW)
        if args.out and dist.get_rank() == 0:
            _write_out(args.out, res, time.perf_counter() - t0)
    finally:
        dist.destroy_process_group()


def _cmd_report(args) -> None:
    from .obs.tracing import trace_span
    with trace_span("faults.report", backend=args.backend):
        cases = run_cases([{"kind": k, "backend": args.backend}
                           for k in KINDS], args.workdir,
                          device=args.device)
    ok = all(c["recovered"] for c in cases)
    report = {"ok": ok, "cases": cases}
    with open(args.out, "w") as f:
        json.dump(report, f, indent=2)
    print(json.dumps(report, indent=2))
    sys.exit(0 if ok else 1)


def _cmd_multiprocess(args) -> None:
    rep = run_multiprocess_case(args.workdir, nprocs=args.nprocs,
                                device=args.device)
    with open(args.out, "w") as f:
        json.dump(rep, f, indent=2)
    print(json.dumps(rep, indent=2))
    sys.exit(0 if rep["recovered"] else 1)


def main(argv: Optional[List[str]] = None) -> None:
    import argparse
    ap = argparse.ArgumentParser(prog="repro_torch.faults")
    sub = ap.add_subparsers(dest="cmd", required=True)

    c = sub.add_parser("child", help="one harness solve (internal)")
    c.add_argument("--device", default=None)
    c.add_argument("--backend", default="sim")
    c.add_argument("--data-shards", type=int, default=1)
    c.add_argument("--problem", default=None)
    c.add_argument("--solve", default=json.dumps(SOLVE_KW))
    c.add_argument("--every", type=int, default=CHECKPOINT_EVERY)
    c.add_argument("--ckpt-dir", default=None)
    c.add_argument("--resume", action="store_true")
    c.add_argument("--out", default=None)
    c.set_defaults(fn=_cmd_child)

    m = sub.add_parser("mp-child", help="one mesh rank (internal)")
    m.add_argument("--rank", type=int, required=True)
    m.add_argument("--nprocs", type=int, required=True)
    m.add_argument("--init", required=True, help="file:// rendezvous")
    m.add_argument("--device", default=None)
    m.add_argument("--ckpt-dir", default=None)
    m.add_argument("--resume", action="store_true")
    m.add_argument("--out", default=None)
    m.set_defaults(fn=_cmd_mp_child)

    r = sub.add_parser("report", help="run every fault kind, write the "
                                      "recovery report")
    r.add_argument("--out", default="RECOVERY_report.json")
    r.add_argument("--workdir", default="faults_run")
    r.add_argument("--backend", default="sim")
    r.add_argument("--device", default="cuda")
    r.set_defaults(fn=_cmd_report)

    p = sub.add_parser("multiprocess", help="kill one rank of a mesh solve "
                                            "and resume")
    p.add_argument("--out", default="MP_RECOVERY_report.json")
    p.add_argument("--workdir", default="faults_mp_run")
    p.add_argument("--nprocs", type=int, default=2)
    p.add_argument("--device", default="cuda")
    p.set_defaults(fn=_cmd_multiprocess)

    args = ap.parse_args(argv)
    args.fn(args)


if __name__ == "__main__":
    main()
