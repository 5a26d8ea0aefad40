"""Multi-rank worlds of the port's mesh runtime, for the CPU tests.

A world is ``WORLD`` processes, one rank each, started by :func:`launch`
as ``python tests/mesh_worlds.py world <layout> <rank> <store> <out>``.
A rank imports torch, numpy and ``repro_torch`` only: never JAX, the
reference package or a test module.  It runs with one intra-op thread,
joins a gloo group on a ``file://`` store (no TCP port) whose every
group times out after ``TIMEOUT_S``, runs every case of its layout in
the same order as the other ranks, and rank 0 writes all results to one
file.  The tests hold those results to the reference, which runs in the
pytest process.

Layouts: ``"1d"`` is a 4x1 ``("tasks",)`` mesh, ``"2d"`` a 2x2
``("tasks", "data")`` mesh.  Each also runs the recovery matrix
(:data:`RECOVERY`): checkpointed and resumed mesh solves, their solve
stores beside the world's ``file://`` store.  ``cluster`` starts two processes that join
over TCP through ``init_cluster``, on a port the OS assigned, the worker
before its coordinator.

The problems are the reference's small shapes, drawn with numpy from
fixed seeds (:func:`arrays`), so both packages see the same inputs.
"""
from __future__ import annotations

import contextlib
import json
import os
import pathlib
import socket
import subprocess
import sys
import time

import numpy as np

ROOT = pathlib.Path(__file__).resolve().parents[1]

WORLD = 4
TIMEOUT_S = 60          # every process group's collective timeout
JOIN_S = 300            # every world, start to finish
CLUSTER_DELAY_S = 1.5   # the TCP coordinator's start after its worker's

# problem shapes: the reference's 2-D parity matrix (tests/test_mesh2d.py),
# its stochastic parity (tests/test_stochastic.py) and its shims
# (tests/test_distributed_core.py)
SPECS = {"sq": dict(p=24, m=8, r=3, n=48, loss="squared"),
         "raw": dict(p=24, m=8, r=3, n=48, loss="squared", gram=False,
                     data="sq"),
         "log": dict(p=16, m=8, r=2, n=48, loss="logistic"),
         "sgd": dict(p=16, m=8, r=2, n=12, loss="squared"),
         "shim": dict(p=40, m=12, r=3, n=60, loss="squared"),
         "shim_log": dict(p=20, m=8, r=2, n=100, loss="logistic")}

# the reference's solver lists and hyper-parameters (tests/test_mesh2d.py)
CASES = {
    "local": {}, "svd_trunc": {}, "bestrep": {"U_star": None},
    "centralize": {"lam": 0.01, "iters": 60},
    "proxgd": {"lam": 0.01, "rounds": 6, "record_every": 2},
    "accproxgd": {"lam": 0.01, "rounds": 6},
    "admm": {"lam": 0.01, "rho": 0.5, "rounds": 5},
    "dfw": {"rounds": 5},
    "dgsp": {"rounds": 3},
    "dnsp": {"rounds": 3, "damping": 0.5, "l2": 1e-3},
    "altmin": {"rounds": 3},
}
RAW_SOLVERS = ["proxgd", "dgsp", "dnsp", "admm", "local", "altmin"]
LOGISTIC = {
    "local": {}, "proxgd": {"lam": 0.01, "rounds": 4},
    "admm": {"lam": 0.01, "rho": 0.5, "rounds": 3},
    "dgsp": {"rounds": 2, "l2": 1e-3},
    "dnsp": {"rounds": 2, "damping": 0.5, "l2": 1e-3},
    "altmin": {"rounds": 2, "u_grad_steps": 5},
}
# (tag, problem, solver, hyper-parameters) of the full-batch matrix
MATRIX = ([("sq", "sq", n, kw) for n, kw in CASES.items()]
          + [("raw", "raw", n, CASES[n]) for n in RAW_SOLVERS]
          + [("log", "log", n, kw) for n, kw in LOGISTIC.items()])

# the stochastic parity (tests/test_stochastic.py)
STOCHASTIC = ("accproxgd", "admm", "dgsp", "dnsp", "proxgd")
STOCH_HP = {"proxgd": {"lam": 0.02, "rounds": 3},
            "accproxgd": {"lam": 0.02, "rounds": 3},
            "admm": {"lam": 0.02, "rho": 0.5, "rounds": 3},
            "dgsp": {"rounds": 3},
            "dnsp": {"rounds": 3, "damping": 0.5, "l2": 1e-3}}
SGD_KW = dict(batch_size=4, local_steps=2, batch_seed=0)
# the solvers that start from the Local solution, a ridge fit that n=12 <
# p=16 leaves singular: the two packages' starts differ by ~8e-2 there,
# so these are also run from W = 0 to be held to the reference
INIT_LOCAL = ("accproxgd", "proxgd")

# the recovery matrix (tests/test_recovery.py): the reference's solve,
# checkpointed every 4 of its 11 rounds, on the harness's problem
# (``repro_torch.faults.demo_problem``), full batch and stochastic
RECOVERY = {"full": dict(method="proxgd", lam=0.05, rounds=11,
                         record_every=3),
            "sgd": dict(method="proxgd", lam=0.05, rounds=11, record_every=3,
                        batch_size=8, local_steps=2, batch_seed=0)}
RECOVERY_EVERY = 4

# the sharded code table (tests/test_serve_mtl.py): p, r, requests, wave
SERVE = dict(p=48, r=4, requests=50, wave=16)
SERVE_MS = (64, 30)                       # divisible and padded tables


def arrays(kind: str):
    """``(X (m, n, p), y (m, n), U* (p, r))`` float32 of one problem."""
    sp = SPECS[kind]
    p, m, r, n = sp["p"], sp["m"], sp["r"], sp["n"]
    rng = np.random.default_rng(sorted(SPECS).index(sp.get("data", kind)))
    U = np.linalg.qr(rng.standard_normal((p, r)))[0]
    Wst = U @ rng.standard_normal((r, m))
    X = rng.standard_normal((m, n, p))
    marg = np.einsum("mnp,pm->mn", X, Wst)
    if sp["loss"] == "squared":
        y = marg + 0.5 * rng.standard_normal(marg.shape)
    else:
        y = np.where(rng.random(marg.shape) < 1 / (1 + np.exp(-marg)),
                     1.0, -1.0)
    return (X.astype(np.float32), y.astype(np.float32),
            U.astype(np.float32))


def hyper(kind: str, name: str, kw: dict) -> dict:
    """``kw`` with bestrep's oracle basis filled in."""
    if "U_star" in kw:
        return dict(kw, U_star=arrays(kind)[2])
    return dict(kw)


def serve_factors(m: int):
    """``(U (p, r), s (r,), V (m, r), ids (N,), X (N, p))`` of one
    sharded-table case."""
    p, r, N = SERVE["p"], SERVE["r"], SERVE["requests"]
    rng = np.random.default_rng(100 + m)
    U = np.linalg.qr(rng.standard_normal((p, r)))[0].astype(np.float32)
    s = np.linspace(2.0, 1.0, r).astype(np.float32)
    V = rng.standard_normal((m, r)).astype(np.float32)
    ids = rng.integers(0, m, N).astype(np.int32)
    X = rng.standard_normal((N, p)).astype(np.float32)
    return U, s, V, ids, X


# ---------------------------------------------------------------------------
# the pytest side: start a world, wait for it, read its results
# ---------------------------------------------------------------------------
def _env():
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        [str(ROOT / "src_torch")]
        + [p for p in env.get("PYTHONPATH", "").split(os.pathsep) if p])
    return env


def _wait(procs, timeout_s: float) -> None:
    """Wait for every ``(process, log)``; kill them all past
    ``timeout_s`` or as soon as one fails, and fail with their logs."""
    deadline = time.monotonic() + timeout_s
    try:
        while any(p.poll() is None for p, _ in procs):
            if any(p.poll() not in (None, 0) for p, _ in procs):
                raise RuntimeError("a rank failed")
            if time.monotonic() > deadline:
                raise TimeoutError(f"the world ran past {timeout_s} s")
            time.sleep(0.05)
        if any(p.returncode for p, _ in procs):
            raise RuntimeError("a rank failed")
    except (RuntimeError, TimeoutError) as e:
        for p, _ in procs:
            if p.poll() is None:
                p.kill()
            p.wait()
        raise AssertionError(f"{e}:\n" + "\n".join(
            f"--- rank {i} rc={p.returncode}\n{log.read_text()}"
            for i, (p, log) in enumerate(procs))) from None


def _start(args, log: pathlib.Path):
    """One rank, its output to ``log`` (a pipe could fill and stall it)."""
    with open(log, "w") as f:
        proc = subprocess.Popen(
            [sys.executable, str(pathlib.Path(__file__))]
            + [str(a) for a in args], env=_env(), stdout=f,
            stderr=subprocess.STDOUT)
    return proc, log


@contextlib.contextmanager
def one_rank_group(tmp_dir):
    """A gloo group of this process alone, on a ``file://`` store under
    ``tmp_dir``, torn down on exit (for in-process tests of the mesh
    path)."""
    import torch.distributed as dist
    from repro_torch.runtime import init_cluster
    init_cluster("file://" + str(pathlib.Path(tmp_dir) / "store"), 1, 0,
                 device="cpu", timeout_s=TIMEOUT_S)
    try:
        yield
    finally:
        dist.destroy_process_group()


def launch(layout: str, tmp_dir) -> dict:
    """Run one world of ``layout`` in ``tmp_dir``; rank 0's results."""
    import torch
    tmp_dir = pathlib.Path(tmp_dir)
    store, out = tmp_dir / "store", tmp_dir / "results.pt"
    t0 = time.monotonic()
    _wait([_start(["world", layout, r, store, out], tmp_dir / f"rank{r}.log")
           for r in range(WORLD)], JOIN_S)
    res = torch.load(out)
    res["seconds"] = time.monotonic() - t0
    return res


def launch_cluster(tmp_dir) -> list:
    """Two processes joining over TCP, the coordinator (rank 0) only
    ``CLUSTER_DELAY_S`` after the worker (rank 1) began to join.  Each
    rank's report, by rank."""
    with socket.socket() as s:          # a port the OS assigns
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    tmp_dir = pathlib.Path(tmp_dir)
    _wait([_start(["cluster", port, r, tmp_dir / "r{}.json"],
                  tmp_dir / f"rank{r}.log") for r in range(2)], JOIN_S)
    return [json.loads((tmp_dir / f"r{r}.json").read_text())
            for r in range(2)]


# ---------------------------------------------------------------------------
# the rank side
# ---------------------------------------------------------------------------
def _problem(kind: str):
    from repro_torch.core.methods import MTLProblem
    X, y, _ = arrays(kind)
    sp = SPECS[kind]
    return MTLProblem.make(X, y, sp["loss"], gram=sp.get("gram", True),
                           A=2.0, r=sp["r"], device="cpu")


def _agree(x) -> bool:
    """Whether every rank holds bit-identical ``x``."""
    import torch
    import torch.distributed as dist
    parts = [torch.empty_like(x) for _ in range(dist.get_world_size())]
    dist.all_gather(parts, x.contiguous())
    return all(torch.equal(p, x) for p in parts)


def _record(res, mesh: bool = True) -> dict:
    ex = res.extras
    return {"W": res.W.clone(), "ledger": res.comm.ledger(),
            "summary": res.comm.summary(), "rounds_axis": res.rounds_axis,
            "n_iterates": len(res.iterates), "backend": ex["backend"],
            "shards": ex["data_shards"],
            "coll": ex["collective_floats_per_chip"],
            "dcoll": ex["data_collective_floats_per_chip"],
            "agree": _agree(res.W) if mesh else True}


def _sim_record(solve, prob, **kw):
    """The port's sim on the same solve, as a record: rank 0 alone runs
    it (only rank 0's results are kept; the others go on to the next
    mesh solve and wait for rank 0 at its first collective)."""
    import torch.distributed as dist
    if dist.get_rank():
        return None
    return _record(solve(prob, device="cpu", **kw), mesh=False)


def _recovery_record(res) -> dict:
    """A record with every iterate, for the bitwise recovery checks."""
    import torch
    return dict(_record(res, mesh=False),
                iterates=torch.stack([w.clone() for w in res.iterates]))


def _recovery(mesh, out, store: str, data_shards: int = 1) -> None:
    """Each RECOVERY solve on the mesh: uninterrupted, checkpointed, and
    resumed from its first segment after rank 0 deleted the later ones;
    and the port's sim on the same solve (rank 0)."""
    import warnings
    import torch.distributed as dist
    import repro_torch
    from repro_torch.faults import demo_problem
    from repro_torch.train import checkpoint as ck
    prob = demo_problem("cpu")
    out["recovery"] = {}
    for tag, kw in RECOVERY.items():
        on = dict(backend="mesh", mesh=mesh, device="cpu", **kw)
        base = repro_torch.solve(prob, **on)
        d = f"{store}.recovery.{tag}"
        seg = repro_torch.solve(prob, checkpoint_every=RECOVERY_EVERY,
                                ckpt_dir=d, **on)
        steps = ck.available_steps(d)
        dist.barrier()
        if dist.get_rank() == 0:
            for s in steps[1:]:
                os.remove(os.path.join(d, f"step_{s:08d}.npz"))
        dist.barrier()
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")     # the rollback warning
            res = repro_torch.resume(d, mesh=mesh, device="cpu")
        sim = None
        if dist.get_rank() == 0:
            sim = _recovery_record(repro_torch.solve(
                prob, data_shards=data_shards, device="cpu", **kw))
        out["recovery"][tag] = {
            "base": _recovery_record(base), "seg": _recovery_record(seg),
            "res": _recovery_record(res), "sim": sim, "steps": steps,
            "checkpoint": res.extras["checkpoint"],
            "agree": _agree(res.W)}


def _refusal(fn) -> str:
    """The message of the ValueError ``fn`` raises ('' if none)."""
    try:
        fn()
    except ValueError as e:
        return str(e)
    return ""


def _full_matrix(solve, mesh, out, data_shards=1):
    probs = {k: _problem(k) for k in ("sq", "raw", "log")}
    out["mesh"], out["sim"] = {}, {}
    for tag, kind, name, kw in MATRIX:
        kw = hyper(kind, name, kw)
        out["mesh"][tag, name] = _record(solve(
            probs[kind], method=name, backend="mesh", mesh=mesh,
            device="cpu", **kw))
        out["sim"][tag, name] = _sim_record(
            solve, probs[kind], method=name, data_shards=data_shards, **kw)


def _stochastic(solve, mesh, out, data_shards=1):
    prob = _problem("sgd")
    for method in STOCHASTIC:
        hp = STOCH_HP[method]
        full = solve(prob, method=method, backend="mesh", mesh=mesh,
                     device="cpu", **hp)
        degen = solve(prob, method=method, backend="mesh", mesh=mesh,
                      batch_size=prob.n, local_steps=1, device="cpu", **hp)
        out["degen"][method] = (_record(full), _record(degen))
        sim = _sim_record(solve, prob, method=method,
                          data_shards=data_shards, **SGD_KW, **hp)
        sim1 = sim if data_shards == 1 else _sim_record(
            solve, prob, method=method, **SGD_KW, **hp)
        on_mesh = solve(prob, method=method, backend="mesh", mesh=mesh,
                        device="cpu", **SGD_KW, **hp)
        out["sgd"][method] = (sim, _record(on_mesh), sim1)
        if method in INIT_LOCAL:
            out["sgd_zeros"][method] = _record(solve(
                prob, method=method, backend="mesh", mesh=mesh,
                device="cpu", init="zeros", **SGD_KW, **hp))


def _shims(mesh, out):
    import repro_torch
    from repro_torch.core.distributed import (dgsp_distributed,
                                              proxgd_distributed)
    prob, prob_log = _problem("shim"), _problem("shim_log")
    sim = dict(backend="sim", device="cpu")
    pairs = {
        "dgsp": (dgsp_distributed(prob, rounds=4, mesh=mesh),
                 repro_torch.solve(prob, method="dgsp", rounds=4, **sim)),
        "dnsp": (dgsp_distributed(prob, rounds=4, mesh=mesh, newton=True,
                                  damping=1e-4),
                 repro_torch.solve(prob, method="dnsp", rounds=4,
                                   damping=1e-4, **sim)),
        "proxgd": (proxgd_distributed(prob, rounds=20, mesh=mesh, lam=0.01),
                   repro_torch.solve(prob, method="proxgd", rounds=20,
                                     lam=0.01, init="zeros", **sim)),
        "dgsp_log": (dgsp_distributed(prob_log, rounds=2, mesh=mesh,
                                      l2=1e-3),
                     repro_torch.solve(prob_log, method="dgsp", rounds=2,
                                       l2=1e-3, **sim)),
    }
    out["shims"] = {k: {"W": d.W.clone(), "coll":
                        d.collective_floats_per_chip, "sim_W": s.W.clone(),
                        "U": d.U.clone() if d.U is not None else None}
                    for k, (d, s) in pairs.items()}
    front = repro_torch.solve(prob, method="dgsp", backend="mesh", mesh=mesh,
                              rounds=4, device="cpu")
    out["shims"]["front_door"] = _record(front)


def _sharded_tables(mesh, out):
    import torch
    from repro_torch.serve.mtl import FactoredModel, MTLServer
    out["serve"] = {}
    for m in SERVE_MS:
        U, s, V, ids, X = serve_factors(m)
        model = FactoredModel(U=torch.from_numpy(U), s=torch.from_numpy(s),
                              V=torch.from_numpy(V))
        ids_t, X_t = torch.from_numpy(ids), torch.from_numpy(X)
        for code in ("f32", "int8"):
            plain = MTLServer(model, batch_size=SERVE["wave"],
                              code_dtype=code)
            srv = MTLServer(model, batch_size=SERVE["wave"], mesh=mesh,
                            code_dtype=code)
            p1, v1 = plain.score(ids_t, X_t)
            p2, v2 = srv.score(ids_t, X_t)
            bad = ""
            try:                      # a padded row's id is no valid id
                srv.score(torch.tensor([m], dtype=torch.int32), X_t[:1])
            except ValueError as e:
                bad = str(e)
            out["serve"][m, code] = {
                "unsharded": p1, "sharded": p2, "v1": v1, "v2": v2,
                "rows": int(srv._state.C.shape[0]),
                "agree": _agree(p2), "bad_id": bad}


def _timeouts(mesh) -> dict:
    """Each mesh axis's group timeout in seconds, as the gloo backend
    holds it."""
    import torch
    return {name: mesh.get_group(name)._get_backend(torch.device("cpu"))
            .options._timeout.total_seconds()
            for name in mesh.mesh_dim_names}


def _cases_1d(out, store):
    import repro_torch
    from repro_torch.runtime import task_data_mesh, task_mesh
    mesh = task_mesh(device="cpu")
    out["timeouts"] = _timeouts(mesh)
    out["degen"], out["sgd"], out["sgd_zeros"] = {}, {}, {}
    _full_matrix(repro_torch.solve, mesh, out)
    _stochastic(repro_torch.solve, mesh, out)
    _shims(mesh, out)
    _sharded_tables(mesh, out)
    _recovery(mesh, out, store)
    X, y, _ = arrays("sq")
    from repro_torch.core.methods import MTLProblem
    six = MTLProblem.make(X[:6], y[:6], "squared", device="cpu")
    out["refusals"] = {
        "m": _refusal(lambda: repro_torch.solve(
            six, method="proxgd", backend="mesh", mesh=mesh, device="cpu")),
        "data_axis": _refusal(lambda: repro_torch.solve(
            _problem("sq"), method="proxgd", backend="mesh", mesh=mesh,
            data_shards=2, device="cpu")),
        "grid": _refusal(lambda: task_data_mesh(3, device="cpu")),
    }


def _cases_2d(out, store):
    import repro_torch
    from repro_torch.core.methods import MTLProblem
    from repro_torch.runtime import task_data_mesh
    mesh = task_data_mesh(2, device="cpu")
    out["timeouts"] = _timeouts(mesh)
    out["degen"], out["sgd"], out["sgd_zeros"] = {}, {}, {}
    _full_matrix(repro_torch.solve, mesh, out, data_shards=2)
    _stochastic(repro_torch.solve, mesh, out, data_shards=2)
    _recovery(mesh, out, store, data_shards=2)
    # the data-axis payloads by the reference's rule: the one Gram-cache
    # all-reduce for gram solvers, one (p, L) pmean a round for raw ProxGD
    out["analytic"] = {
        "dgsp": repro_torch.solve(
            _problem("sq"), method="dgsp", backend="mesh", mesh=mesh,
            rounds=3, device="cpu").extras["data_collective_floats_per_chip"],
        "proxgd_raw": repro_torch.solve(
            _problem("raw"), method="proxgd", backend="mesh", mesh=mesh,
            rounds=6, lam=0.01, device="cpu"
        ).extras["data_collective_floats_per_chip"]}
    X, y, _ = arrays("sq")
    odd = MTLProblem.make(X[:, :45], y[:, :45], "squared", device="cpu")
    out["refusals"] = {
        "n": _refusal(lambda: repro_torch.solve(
            odd, method="proxgd", backend="mesh", mesh=mesh, device="cpu")),
        "contradicts": _refusal(lambda: repro_torch.solve(
            _problem("sq"), method="proxgd", backend="mesh", mesh=mesh,
            data_shards=4, device="cpu")),
    }


def _all_ready(store: str, rank: int) -> None:
    """Mark this rank's imports done and wait for every rank's, so that
    the group's 60 s rendezvous never waits on a slow ``import torch``."""
    pathlib.Path(f"{store}.ready{rank}").touch()
    deadline = time.monotonic() + JOIN_S
    while not all(pathlib.Path(f"{store}.ready{r}").exists()
                  for r in range(WORLD)):
        if time.monotonic() > deadline:
            raise TimeoutError("the other ranks never started")
        time.sleep(0.05)


def _rank_world(layout: str, rank: int, store: str, out_path: str) -> None:
    import torch
    torch.set_num_threads(1)
    import torch.distributed as dist
    # every module the cases run, imported before the rendezvous
    import repro_torch.core.distributed  # noqa: F401
    import repro_torch.core.methods  # noqa: F401
    import repro_torch.faults  # noqa: F401
    import repro_torch.runtime.recovery  # noqa: F401
    import repro_torch.serve.mtl  # noqa: F401
    from repro_torch.runtime import init_cluster
    _all_ready(store, rank)
    init_cluster("file://" + store, WORLD, rank, device="cpu",
                 timeout_s=TIMEOUT_S)
    try:
        out = {"layout": layout}
        (_cases_1d if layout == "1d" else _cases_2d)(out, store)
        if rank == 0:
            torch.save(out, out_path)
    finally:
        dist.destroy_process_group()


def _rank_cluster(port: int, rank: int, out_pattern: str) -> None:
    import torch
    torch.set_num_threads(1)
    import torch.distributed as dist
    from repro_torch.runtime import init_cluster
    joining = pathlib.Path(out_pattern.format(1) + ".joining")
    t0 = time.monotonic()
    if rank == 1:
        # the worker takes every argument from the REPRO_* environment
        os.environ.update(REPRO_COORDINATOR=f"localhost:{port}",
                          REPRO_NUM_PROCESSES="2", REPRO_PROCESS_ID="1")
        joining.touch()
        init_cluster(device="cpu", timeout_s=TIMEOUT_S, backoff_s=0.25,
                     retries=8)
    else:
        # the coordinator comes up only after the worker began to join
        deadline = time.monotonic() + JOIN_S
        while not joining.exists() and time.monotonic() < deadline:
            time.sleep(0.05)
        time.sleep(CLUSTER_DELAY_S)
        init_cluster(f"localhost:{port}", 2, 0, device="cpu",
                     timeout_s=TIMEOUT_S)
    joined = time.monotonic() - t0
    try:
        x = torch.tensor([float(rank + 1)])
        dist.all_reduce(x)
        pathlib.Path(out_pattern.format(rank)).write_text(json.dumps(
            {"rank": dist.get_rank(), "world": dist.get_world_size(),
             "backend": str(dist.get_backend()), "sum": float(x),
             "joined_after_s": joined}))
    finally:
        dist.destroy_process_group()


if __name__ == "__main__":
    what, args = sys.argv[1], sys.argv[2:]
    if what == "world":
        _rank_world(args[0], int(args[1]), args[2], args[3])
    elif what == "cluster":
        _rank_cluster(int(args[0]), int(args[1]), args[2])
    else:
        raise SystemExit(f"unknown world {what!r}")
