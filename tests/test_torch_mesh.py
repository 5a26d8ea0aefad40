"""The port's mesh runtime on a 1-D layout, against the JAX reference.

One world of four gloo ranks on a ``file://`` store (``mesh_worlds``,
a 4x1 ``("tasks",)`` mesh) runs every case once for the module; the
reference runs its simulated cluster in this process on the same numpy
inputs, as the reference itself holds its mesh to its sim.

Pass criteria, per case:
* the full-batch matrix (the reference's solver lists on the squared
  Gram, squared raw and logistic paths): ``max|W_mesh - W_ref| <= 1e-4 *
  max(1, max|W_ref|)``; ledger, ``comm.summary()`` and ``rounds_axis``
  equal to the reference's; ``collective_floats_per_chip ==
  floats_by_direction("worker->master") * m/T``; no data-axis floats;
  every rank returns the same W bit for bit;
* the stochastic solvers: ``B=n, L=1`` on the mesh equals the
  full-batch mesh solve bitwise (W, ledger, counter), and the mesh equals
  the port's sim on the same stochastic configuration bitwise
  (tests/test_stochastic.py:280-289);
* the shims equal the sim within 1e-5 (logistic 1e-4), the front door
  equals the shim exactly (tests/test_distributed_core.py);
* the sharded code table equals the unsharded server within 1e-6, for
  m=64 and a padded m=30, f32 and int8, with the same version id;
* the reference's refusals; the mesh's group times out after the
  ``init_cluster`` timeout; and ``init_cluster`` over TCP on a port the
  OS assigned, the worker started before its coordinator.
"""
import pathlib
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")
sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1] / "src_torch"))

import jax.numpy as jnp  # noqa: E402

import mesh_worlds as mw  # noqa: E402
import repro  # noqa: E402
from repro.core.methods import MTLProblem as JProblem  # noqa: E402
from repro.serve.mtl import FactoredModel as JModel  # noqa: E402
from repro.serve.mtl import MTLServer as JServer  # noqa: E402

W_RTOL = 1e-4        # DESIGN.md §3's solver bound, as in test_torch_solvers
T = mw.WORLD         # ranks on the tasks axis


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    return mw.launch("1d", tmp_path_factory.mktemp("mesh1d"))


def _jproblem(kind):
    X, y, _ = mw.arrays(kind)
    sp = mw.SPECS[kind]
    return JProblem.make(jnp.asarray(X), jnp.asarray(y), sp["loss"],
                         gram=sp.get("gram", True), A=2.0, r=sp["r"])


def _ref(kind, name, kw, **solve_kw):
    kw = mw.hyper(kind, name, kw)
    if "U_star" in kw:
        kw["U_star"] = jnp.asarray(kw["U_star"])
    return repro.solve(_jproblem(kind), method=name, backend="sim",
                       **solve_kw, **kw)


def _close(W, Wj):
    Wj = np.asarray(Wj)
    tol = W_RTOL * max(1.0, float(np.abs(Wj).max()))
    err = float(np.abs(np.asarray(W) - Wj).max())
    assert err <= tol, f"max|W_port - W_ref| = {err} > {tol}"


@pytest.mark.parametrize("tag,kind,name,kw", mw.MATRIX,
                         ids=[f"{t}-{n}" for t, _, n, _ in mw.MATRIX])
def test_mesh_matches_reference(world, tag, kind, name, kw):
    row = world["mesh"][tag, name]
    rj = _ref(kind, name, kw)
    _close(row["W"], rj.W)
    assert row["ledger"] == rj.comm.ledger()
    assert row["summary"] == rj.comm.summary()
    assert row["rounds_axis"] == rj.rounds_axis
    assert row["n_iterates"] == len(rj.iterates)
    m = mw.SPECS[kind]["m"]
    assert row["coll"] == rj.comm.floats_by_direction("worker->master") \
        * (m // T)
    assert row["dcoll"] == 0 and row["shards"] == 1
    assert row["backend"] == "mesh" and row["agree"]
    # and the port's own sim on the same problem, in the same world
    sim = world["sim"][tag, name]
    assert sim["ledger"] == row["ledger"] and sim["coll"] == 0
    _close(row["W"], sim["W"].numpy())


@pytest.mark.parametrize("method", mw.STOCHASTIC)
def test_mesh_degenerate_batch_is_the_full_batch_bitwise(world, method):
    full, degen = world["degen"][method]
    assert torch.equal(full["W"], degen["W"])
    assert full["ledger"] == degen["ledger"]
    assert full["coll"] == degen["coll"] > 0


@pytest.mark.parametrize("method", mw.STOCHASTIC)
def test_mesh_stochastic_matches_sim_bitwise(world, method):
    sim, mesh, _ = world["sgd"][method]
    assert torch.equal(sim["W"], mesh["W"])
    assert sim["ledger"] == mesh["ledger"] and mesh["agree"]
    kw = dict(mw.SGD_KW)
    if method in mw.INIT_LOCAL:
        mesh, kw["init"] = world["sgd_zeros"][method], "zeros"
    rj = _ref("sgd", method, mw.STOCH_HP[method], **kw)
    _close(mesh["W"], rj.W)
    assert mesh["ledger"] == rj.comm.ledger()


def test_shims_match_the_simulated_cluster(world):
    sh = world["shims"]
    for name, tol in (("dgsp", 1e-5), ("dnsp", 1e-5), ("proxgd", 1e-5),
                      ("dgsp_log", 1e-4)):
        err = float((sh[name]["W"] - sh[name]["sim_W"]).abs().max())
        assert err < tol, (name, err)
    m, p = mw.SPECS["shim"]["m"], mw.SPECS["shim"]["p"]
    # Table 1: 1 p-vector per simulated machine per round
    assert sh["dgsp"]["coll"] == 4 * (m // T) * p
    front = sh["front_door"]
    assert torch.equal(front["W"], sh["dgsp"]["W"])
    assert front["summary"]["vectors_per_round"] == 2
    assert front["coll"] == 4 * (m // T) * p
    assert sh["dgsp"]["U"].shape == (p, 4)


@pytest.mark.parametrize("m", mw.SERVE_MS)
@pytest.mark.parametrize("code", ["f32", "int8"])
def test_sharded_table_matches_the_unsharded_server(world, m, code):
    row = world["serve"][m, code]
    err = float((row["sharded"] - row["unsharded"]).abs().max())
    assert err <= 1e-6, err
    assert row["v1"] == row["v2"] and row["agree"]
    assert row["rows"] == -(-m // T)            # padded to a multiple of T
    assert "outside [0, %d)" % m in row["bad_id"]
    if code == "f32":
        U, s, V, ids, X = mw.serve_factors(m)
        ref, _ = JServer(JModel(U=jnp.asarray(U), s=jnp.asarray(s),
                                V=jnp.asarray(V)),
                         batch_size=mw.SERVE["wave"]).score(
            jnp.asarray(ids), jnp.asarray(X))
        np.testing.assert_allclose(row["sharded"].numpy(), np.asarray(ref),
                                   rtol=1e-5, atol=1e-4)


def test_mesh_refusals_are_the_references(world):
    ref = world["refusals"]
    assert "m=6 tasks must be divisible by the 4 devices" in ref["m"]
    assert "needs a mesh with a 'data' axis" in ref["data_axis"]
    assert "cannot form a mesh with data_shards=3" in ref["grid"]


def test_mesh_group_times_out_as_init_cluster_set(world):
    assert world["timeouts"] == {"tasks": mw.TIMEOUT_S}


def test_init_cluster_joins_over_tcp_with_a_late_coordinator(tmp_path):
    """The worker starts first, from the REPRO_* environment, waits for
    its coordinator with backoff, and joins the same 2-rank gloo group."""
    reports = mw.launch_cluster(tmp_path)
    assert [r["rank"] for r in reports] == [0, 1]
    for r in reports:
        assert r["world"] == 2 and r["backend"] == "gloo"
        assert r["sum"] == 3.0
    assert reports[1]["joined_after_s"] > 1.0    # it waited for rank 0


# ---------------------------------------------------------------------------
# recovery on the mesh (tests/test_recovery.py's mesh matrix)
# ---------------------------------------------------------------------------
def _same_solve(a, b, counters=True):
    assert torch.equal(a["W"], b["W"])
    assert torch.equal(a["iterates"], b["iterates"])
    assert a["ledger"] == b["ledger"] and a["rounds_axis"] == b["rounds_axis"]
    if counters:
        assert (a["coll"], a["dcoll"]) == (b["coll"], b["dcoll"])


@pytest.mark.parametrize("tag", sorted(mw.RECOVERY))
def test_mesh_recovery_and_resumed_bitidentical(world, tag):
    """Checkpointed every 4 rounds, and resumed from the first segment
    after the later ones were deleted, the mesh solve equals the
    uninterrupted mesh solve bitwise (W, iterates, ledger, both
    collective-float counters) and the port's sim bitwise; the resumed W
    is within the solver bound of the reference's uninterrupted solve,
    with its ledger."""
    row = world["recovery"][tag]
    _same_solve(row["base"], row["seg"])
    _same_solve(row["base"], row["res"])
    _same_solve(row["base"], row["sim"], counters=False)
    assert row["steps"] == [4, 8, 11] and row["agree"]
    assert row["checkpoint"]["resumed_from"] == mw.RECOVERY_EVERY
    assert row["checkpoint"]["rolled_back_from"] == 11
    assert row["base"]["coll"] > 0
    from repro.faults import demo_problem as ref_problem
    rj = repro.solve(ref_problem(), **mw.RECOVERY[tag])
    _close(row["res"]["W"], rj.W)
    assert row["res"]["ledger"] == rj.comm.ledger()


def test_mesh_static_verify(world):
    """``repro_torch.analysis`` on the 4x1 layout: every cell of the
    matrix (each solver, full batch and stochastic) verifies and charges
    the floats and vectors per round of the port's sim, which
    ``test_torch_analysis.py`` holds to the reference's;
    ``verify="static"`` returns W and the ledger bitwise the unverified
    solve's; a gather that also moves an uncharged all-reduce is refused
    with COMM001 naming the op, the axis and the floats."""
    from repro_torch.analysis.verify import STOCHASTIC_CASES, STOCHASTIC_TAG
    v = world["verify"]
    cases = v["report"]["cases"]
    assert v["report"]["ok"], ([c["findings"] for c in cases]
                               + v["report"]["cross_findings"])
    labels = sorted(repro.core.solver_names()) + \
        [m + STOCHASTIC_TAG for m in sorted(STOCHASTIC_CASES)]
    assert [(c["method"], c["layout"], c["driver"]) for c in cases] == \
        [(m, "mesh", "scan") for m in labels]
    sim = mw.sim_charges()
    for c in cases:
        assert (c["charged_floats_per_machine"],
                c["charged_vectors_per_round"]) == sim[c["method"]], \
            c["method"]
    assert v["static_verify"] == "ok" and v["bitwise"] and v["ledger_equal"]
    assert "COMM001" in v["refused"] and "c10d.allreduce_" in v["refused"]
    assert "'tasks'" in v["refused"] and "floats" in v["refused"]
