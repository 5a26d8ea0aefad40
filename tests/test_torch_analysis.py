"""The port's static checks (``repro_torch.analysis``) against the JAX
reference and against DESIGN.md §11, on the CPU.

* Per solver, full batch and stochastic, on the sim: the port's
  ``CaseReport`` charges the reference's floats per machine and vectors
  per round and measures the same (zero) collective floats, and both
  verify.
* Every fault DESIGN.md §11 names, planted in a round body on a gloo
  mesh of this process alone, is refused with its code, and the finding
  names the op, the axis and the float count (or, for the SHRD lints,
  the leaf); so is a collective around the rounds that is not the round
  data's data-axis setup or the hand-back's gather of a sharded leaf.
  The reference's own walker tests are not the bar: seven of them fail
  on every driver run.
* The carry drift the checks found in port code stays repaired: the
  lazy spectral basis and stochastic ADMM's W on the fused step's path.
* ``solve(verify="static")`` verifies, returns W and the ledger bitwise
  the unverified solve's, refuses a runtime that moves an uncharged
  collective, and refuses other modes and ``runtime=``.
* The matrix verifies on the one-rank mesh, the CLI says which cells
  it ran and exits 0; the port's tree lints clean, and each rule fires
  on a planted file.
"""
import pathlib
import subprocess
import sys
import textwrap

import pytest

torch = pytest.importorskip("torch")
ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src_torch"))

import torch.distributed as dist  # noqa: E402

import mesh_worlds  # noqa: E402
import repro.analysis as janalysis  # noqa: E402
from repro.analysis.verify import STOCHASTIC_CASES  # noqa: E402
import repro_torch  # noqa: E402
from repro_torch.analysis import (AnalysisError, StaticCapture,  # noqa: E402
                                  build_problem, check_trace, lint_file,
                                  lint_repo, trace_solver)
from repro_torch.analysis import verify as tverify  # noqa: E402
from repro_torch.core.methods import solver_names  # noqa: E402
from repro_torch.runtime import MeshRuntime, task_data_mesh, task_mesh  # noqa: E402
from repro_torch.runtime.mesh import _all_gather  # noqa: E402

CELLS = [(m, None) for m in sorted(solver_names())] + \
    [(m, STOCHASTIC_CASES[m]) for m in sorted(STOCHASTIC_CASES)]


@pytest.fixture(scope="module")
def ref_problem():
    return janalysis.build_problem()


@pytest.mark.parametrize("method,hp", CELLS,
                         ids=[m + ("" if hp is None else "+sgd")
                              for m, hp in CELLS])
def test_sim_report_is_the_references(ref_problem, method, hp):
    jrep = janalysis.check_trace(janalysis.trace_solver(
        method, "sim", "scan", prob=ref_problem[0], extras=ref_problem[1],
        hp=None if hp is None else dict(hp)))
    rep = check_trace(trace_solver(method, "sim", "scan",
                                   hp=None if hp is None else dict(hp),
                                   device="cpu"))
    assert rep.ok and jrep.ok, (rep.findings, jrep.findings)
    for field in ("charged_floats_per_machine", "charged_vectors_per_round",
                  "measured_task_floats_per_chip",
                  "measured_data_floats_per_chip"):
        assert getattr(rep, field) == getattr(jrep, field), field


# ---------------------------------------------------------------------------
# planted faults, on a gloo mesh of this process alone
# ---------------------------------------------------------------------------
@pytest.fixture(scope="module")
def group(tmp_path_factory):
    with mesh_worlds.one_rank_group(tmp_path_factory.mktemp("analysis")):
        yield


def _capture(body, rounds=3, state=None, sharded=(), data_axis=False):
    """Run ``body(rt, k, state, data)`` for ``rounds`` rounds on a mesh
    runtime under a capture; its report.  ``data_axis`` gives the
    runtime a (1, 1) mesh whose "data" group the body may use."""
    prob, _ = build_problem(device="cpu")
    mesh = (task_data_mesh(1, device="cpu") if data_axis
            else task_mesh(device="cpu"))
    rt = MeshRuntime(prob, mesh=mesh)
    if data_axis:
        rt._data_group = mesh.get_group("data")
    cap = StaticCapture(rounds)
    rt._capture = cap
    if state is None:
        state = {"W": torch.zeros((prob.p, prob.m))}
    with cap:
        rt.run_rounds(rounds, lambda k, s, d: body(rt, k, s, d), state,
                      sharded=sharded, data_leaves=("gram_A", "gram_b"))
    return check_trace(cap.trace("planted", "mesh", "scan")), prob


def _hits(rep, code):
    hits = [str(f) for f in rep.findings if f.code == code]
    assert hits, rep.findings
    return hits[0]


def test_uncharged_all_reduce_is_refused(group):
    def body(rt, k, state, data):
        s = state["W"].sum(dim=1)                     # (p,), uncharged
        dist.all_reduce(s, group=rt._tasks_group)
        return {"W": rt.broadcast(state["W"] + s[:, None], "untracked")}

    rep, prob = _capture(body)
    msg = _hits(rep, "COMM001")
    assert "c10d.allreduce_" in msg and "'tasks'" in msg
    assert f"{prob.p} floats" in msg and "3x" in msg


def test_phantom_charge_is_refused(group):
    def body(rt, k, state, data):
        rt._charge("worker->master", 1, rt.prob.p, "phantom", wire=0,
                   kind="psum", payload=rt.prob.p)
        return {"W": state["W"] + 1.0}

    rep, prob = _capture(body)
    msg = _hits(rep, "COMM002")
    assert "psum" in msg and "'tasks'" in msg and f"{prob.p} floats" in msg


def test_wrong_repeats_is_refused(group):
    """A data-axis all-reduce issued once a round but charged as three
    (``repeats=3``): COMM002, the charge claims what never moved."""
    def body(rt, k, state, data):
        g = state["W"].sum(dim=0)                     # (m,)
        rt._charge_data("psum", g.numel(), repeats=3, note="overcounted")
        dist.all_reduce(g, group=rt._data_group)
        return {"W": state["W"] + g[None, :]}

    rep, prob = _capture(body, data_axis=True)
    msg = _hits(rep, "COMM002")
    assert "psum" in msg and "'data'" in msg and f"{prob.m} floats" in msg
    assert "9x" in msg and "c10d.allreduce_ runs 3x" in msg


def test_collective_in_a_local_step_is_refused(group):
    """DESIGN.md §13's local steps buy FLOPs, never wire: a worker that
    peeks at its neighbours mid-step is an uncharged tasks-axis
    all-gather."""
    def body(rt, k, state, data):
        Wl = rt.local_slice(state["W"])
        for i in range(3):
            Wl = Wl * 0.9
            if i == 1:
                full = _all_gather(Wl, rt._tasks_group, 1, 1)
                Wl = Wl + 0.0 * full[:, :Wl.shape[1]]
        W = rt.gather_columns(Wl, "locally stepped columns")
        return {"W": rt.broadcast(W, "updated predictor")}

    rep, prob = _capture(body)
    msg = _hits(rep, "COMM001")
    assert "c10d._allgather_base_" in msg and "'tasks'" in msg
    assert f"{prob.p * prob.m} floats" in msg
    # the charged gather of the same size is matched, the peek is not
    assert "runs 6x" in msg and "charges it only 3x" in msg


def test_count_that_changes_in_round_two_is_refused(group):
    """The same charges every round, one more collective in round 2:
    replaying round 1's template would mis-charge it (COMM003)."""
    def body(rt, k, state, data):
        W = state["W"]
        if k == 1:
            s = W.sum(dim=0)
            dist.all_reduce(s, group=rt._tasks_group)
            W = W + 0.0 * s[None, :]
        return {"W": rt.gather_columns(rt.local_slice(W), "columns")}

    rep, prob = _capture(body)
    msg = _hits(rep, "COMM003")
    assert "round 2" in msg and "c10d.allreduce_" in msg
    assert "'tasks'" in msg and f"[{prob.m} floats]" in msg


def test_collective_outside_the_rounds_is_refused(group):
    prob, _ = build_problem(device="cpu")
    rt = MeshRuntime(prob, mesh=task_mesh(device="cpu"))
    cap = StaticCapture()
    rt._capture = cap
    with cap:
        dist.all_reduce(torch.ones(5), group=rt._tasks_group)
        rt.run_rounds(2, lambda k, s, d: s, {"W": torch.zeros((prob.p,
                                                                prob.m))})
    rep = check_trace(cap.trace("planted", "mesh", "scan"))
    msg = _hits(rep, "COMM003")
    assert "c10d.allreduce_" in msg and "no round body" in msg


def test_a_collective_on_the_sim_is_refused(group):
    """The simulated cluster moves no bytes: any c10d op in its rounds is
    uncharged (COMM001), whatever group it runs on."""
    prob, _ = build_problem(device="cpu")
    rt = tverify.layout_runtime(prob, "sim")
    cap = StaticCapture()
    rt._capture = cap

    def body(k, state, data):
        s = state["W"].sum(dim=0)
        dist.all_reduce(s)
        return {"W": rt.gather_columns(state["W"] + 0.0 * s, "columns")}

    with cap:
        rt.run_rounds(3, body, {"W": torch.zeros((prob.p, prob.m))})
    rep = check_trace(cap.trace("planted", "sim", "scan"))
    msg = _hits(rep, "COMM001")
    assert "c10d.allreduce_" in msg and "'world'" in msg
    assert f"{prob.m} floats" in msg


def _finding(rep, code, phase):
    hits = [str(f) for f in rep.findings if f.code == code and phase in str(f)]
    assert hits, rep.findings
    return hits[0]


def test_tasks_axis_collective_in_the_setup_is_refused(group, monkeypatch):
    """The round data's setup may reduce over the data axis only: a
    tasks-axis all-reduce there is charged nowhere (COMM003)."""
    real = MeshRuntime._round_data

    def rogue(self):
        data = real(self)
        dist.all_reduce(torch.ones(7), group=self._tasks_group)
        return data

    monkeypatch.setattr(MeshRuntime, "_round_data", rogue)
    rep, _ = _capture(lambda rt, k, s, d: {"W": s["W"] + 1.0})
    msg = _finding(rep, "COMM003", "setup")
    assert "c10d.allreduce_" in msg and "'tasks'" in msg
    assert "7 floats" in msg


def test_extra_collective_among_the_output_gathers_is_refused(group,
                                                              monkeypatch):
    """Handing back a sharded leaf is one tasks-axis all-gather of its
    local columns; an all-reduce beside it is charged nowhere
    (COMM003), while the gather itself is expected."""
    real = MeshRuntime._global_entry

    def rogue(self, value, shard_it):
        out = real(self, value, shard_it)
        if shard_it:
            dist.all_reduce(out.sum(dim=0), group=self._tasks_group)
        return out

    monkeypatch.setattr(MeshRuntime, "_global_entry", rogue)
    rep, prob = _capture(lambda rt, k, s, d: {"W": s["W"] + 1.0},
                         sharded=("W",))
    msg = _finding(rep, "COMM003", "output gathers")
    assert "c10d.allreduce_" in msg and "'tasks'" in msg
    assert f"{prob.m} floats" in msg and "runs 1x" in msg
    assert not [f for f in rep.findings if "all_gather" in str(f)]


@pytest.mark.parametrize("drift", ["strides", "dtype", "scalar"])
def test_carry_drift_is_refused(group, drift):
    def body(rt, k, state, data):
        W = state["W"] + 1.0
        if drift == "strides":
            W = W.t().contiguous().t()
        elif drift == "dtype":
            W = W.double()
        step = torch.as_tensor(state["step"] + 1) if drift == "scalar" \
            else state["step"] + 1
        return {"W": W, "step": step}

    prob, _ = build_problem(device="cpu")
    rep, _ = _capture(body, state={"W": torch.zeros((prob.p, prob.m)),
                                   "step": 0})
    msg = _hits(rep, "SHRD003")
    assert ("['step']" if drift == "scalar" else "['W']") in msg


def test_in_place_write_to_a_handed_out_iterate_is_refused(group):
    """Round k writes into the tensor round k-1 returned (and a recorder
    kept as its iterate)."""
    def body(rt, k, state, data):
        state["W"].add_(1.0)
        return {"W": state["W"]}

    rep, _ = _capture(body)
    msg = _hits(rep, "SHRD002")
    assert "['W']" in msg and "in place" in msg


def test_replicated_leaf_larger_than_the_sharded_ones_is_refused(group):
    prob, _ = build_problem(device="cpu")
    big = torch.zeros((prob.m, prob.p, prob.p + 1))   # > gram_A (m, p, p)

    def body(rt, k, state, data):
        return dict(state)

    rep, _ = _capture(body, state={"W": torch.zeros((prob.p, prob.m)),
                                   "big": big}, sharded=("W",))
    msg = _hits(rep, "SHRD001")
    assert "state['big']" in msg and str(big.numel()) in msg


@pytest.mark.parametrize("method", ["proxgd", "accproxgd", "admm"])
def test_lazy_spectral_carry_keeps_one_layout(method):
    """m > r + 8 engages the lazy spectral master, whose carried basis
    comes out of a QR, the SVD's Vh or a Ritz product, each laid out
    otherwise: the carry keeps one layout across rounds (SHRD003)."""
    from repro_torch.core import prng
    from repro_torch.core.methods import MTLProblem
    from repro_torch.data.synthetic import SimSpec, generate
    Xs, ys, _, _ = generate(prng.PRNGKey(0, device="cpu"),
                            SimSpec(p=12, m=16, n=8, r=2), device="cpu")
    prob = MTLProblem.make(Xs, ys, r=2, device="cpu")
    assert tverify.verify_static(prob, method, rounds=6, lam=0.05).ok


def test_stochastic_admm_carry_keeps_one_layout(monkeypatch):
    """On the card the fused prox step hands back a transposed view
    (``minibatch_prox_step_columns``); forced onto that path here (its
    wrapper runs the plain version on a CPU tensor), stochastic ADMM's W
    carry keeps one layout across rounds (SHRD003)."""
    from repro_torch.core import worker_ops
    monkeypatch.setattr(worker_ops, "_resolve_step_impl",
                        lambda loss, data, impl: impl or "kernel")
    prob, _ = build_problem(device="cpu")
    assert tverify.verify_static(prob, "admm", rounds=3, batch_size=4,
                                 local_steps=2).ok


# ---------------------------------------------------------------------------
# solve(verify="static")
# ---------------------------------------------------------------------------
def test_verify_static_on_the_mesh_and_a_rogue_runtime(group, monkeypatch):
    prob, _ = build_problem(device="cpu")
    kw = dict(method="proxgd", rounds=4, lam=0.01, init="zeros",
              backend="mesh", device="cpu")
    plain = repro_torch.solve(prob, **kw)
    res = repro_torch.solve(prob, verify="static", **kw)
    assert res.extras["static_verify"] == "ok"
    assert torch.equal(res.W, plain.W)
    assert res.comm.ledger() == plain.comm.ledger()
    real = MeshRuntime.gather_columns

    def rogue(self, x, note=""):
        s = x.sum(dim=0)
        dist.all_reduce(s, group=self._tasks_group)   # never charged
        return real(self, x, note)

    monkeypatch.setattr(MeshRuntime, "gather_columns", rogue)
    with pytest.raises(AnalysisError) as ei:
        repro_torch.solve(prob, verify="static", **kw)
    assert "COMM001" in str(ei.value) and "c10d.allreduce_" in str(ei.value)


def test_verify_static_front_door_refusals():
    prob, _ = build_problem(device="cpu")
    kw = dict(method="proxgd", rounds=2, device="cpu")
    with pytest.raises(ValueError, match="unknown verify mode"):
        repro_torch.solve(prob, verify="dynamic", **kw)
    rt = tverify.layout_runtime(prob, "sim")
    with pytest.raises(ValueError, match="runtime="):
        repro_torch.solve(prob, verify="static", runtime=rt, **kw)


def test_twin_runs_at_most_the_stated_rounds():
    prob, _ = build_problem(device="cpu")
    trace = tverify.capture_solve(tverify.layout_runtime(prob, "sim"), prob,
                                  "proxgd", layout="sim",
                                  hp={"rounds": 50, "init": "zeros"})
    assert trace.rounds == list(range(tverify.VERIFY_ROUNDS))
    assert trace.comm.rounds == tverify.VERIFY_ROUNDS


def test_one_rank_mesh_matrix_verifies(group):
    """Every solver, full batch and stochastic, on the one-rank gloo
    mesh under both driver names: verified, and the ledger the same in
    every cell of a solver (COMM006)."""
    report = tverify.run_analysis(layouts=("mesh",), lint_paths=False,
                                  device="cpu")
    assert report.ok, report.render()
    assert len(report.cases) == 2 * len(CELLS)


def test_cli_reports_its_cells(tmp_path):
    out = tmp_path / "report.json"
    proc = subprocess.run(
        [sys.executable, "-m", "repro_torch.analysis", "--methods",
         "proxgd", "dgsp", "--device", "cpu", "--json", str(out)],
        cwd=tmp_path, capture_output=True, text=True, timeout=240,
        env=mesh_worlds._env())
    assert proc.returncode == 0, proc.stdout[-3000:] + proc.stderr[-3000:]
    assert "PASS: 16 cases verified, 0 finding(s)" in proc.stdout
    assert "cells on cpu: sim, mesh (mesh: one gloo rank) x scan, eager" \
        in proc.stdout
    import json
    report = json.loads(out.read_text())
    assert report["ok"] and len(report["cases"]) == 16
    assert {(c["layout"], c["driver"]) for c in report["cases"]} == {
        (lay, d) for lay in ("sim", "mesh") for d in ("scan", "eager")}


# ---------------------------------------------------------------------------
# the repo lints
# ---------------------------------------------------------------------------
def _lint_src(tmp_path, rel, src):
    path = tmp_path / rel
    path.parent.mkdir(parents=True, exist_ok=True)
    path.write_text(textwrap.dedent(src))
    return lint_file(path, rel)


PKG = "src_torch/repro_torch/"


def test_port_tree_lints_clean():
    assert lint_repo(ROOT) == []


def test_lint_svd_outside_spectral(tmp_path):
    src = """
        import torch
        def f(M):
            return torch.linalg.svdvals(M), torch.linalg.svd(M)
    """
    hits = _lint_src(tmp_path, PKG + "core/methods/foo.py", src)
    assert [f.code for f in hits] == ["LINT101", "LINT101"]
    assert _lint_src(tmp_path, PKG + "core/spectral.py", src) == []


def test_lint_host_reads_on_the_hot_paths(tmp_path):
    src = """
        import torch
        def f(x):
            torch.cuda.synchronize()
            return x.sum().item(), x.tolist(), x.cpu().numpy()
    """
    hits = _lint_src(tmp_path, PKG + "core/worker_ops.py", src)
    assert [f.code for f in hits] == ["LINT102"] * 5
    assert _lint_src(tmp_path, PKG + "core/methods/foo.py", src) == []
    serve = """
        class MTLServer:
            def _score_with(self, st, ids, X):
                return X.sum().item()
            def swap(self, model):
                return model.U.cpu()
        def _score_batch(U, C, ids, X, m):
            return ids.tolist()
    """
    hits = _lint_src(tmp_path, PKG + "serve/mtl.py", serve)
    assert [f.where.rsplit(":", 1)[1] for f in hits] == ["4", "8"]


def test_lint_serve_state_mutation(tmp_path):
    src = """
        def swap(self):
            st = _ServeState(model=1)
            st.C = None
            object.__setattr__(st, "U", 0)
            return st
    """
    hits = _lint_src(tmp_path, PKG + "serve/mtl.py", src)
    assert sorted(f.code for f in hits) == ["LINT103", "LINT103"]
    ok = """
        def swap(self):
            st = _ServeState(model=1)
            self._state = st
            return st
    """
    assert _lint_src(tmp_path, PKG + "serve/mtl.py", ok) == []


def test_lint_kernel_builds_confined_to_kernels(tmp_path):
    src = """
        import ctypes, subprocess, triton
        def build(src):
            subprocess.run(["nvcc", "-O3", src])
            return ctypes.CDLL("lib.so")
        @triton.jit
        def kern(x_ptr):
            pass
    """
    hits = _lint_src(tmp_path, PKG + "serve/mtl.py", src)
    assert [f.code for f in hits] == ["LINT104"] * 3
    assert _lint_src(tmp_path, PKG + "kernels/mtl_score/kernel.py",
                     src) == []
