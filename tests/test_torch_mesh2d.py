"""The port's 2-D ``("tasks", "data")`` layouts, against the JAX reference.

Two halves:
* in this process, the simulated cluster's 2-D emulation
  (``SimRuntime(data_shards=D)``) on the reference's solver lists at D=4,
  against the reference's own emulation (``tests/test_mesh2d.py:209``):
  ``max|W - W_ref| <= 1e-4 * max(1, max|W_ref|)``, the same ledger and
  ``rounds_axis``, and no collective floats on either axis; the
  shard-summed Gram cache; the refusals; the emulation's determinism
  and its refusal of shards that reach different collectives;
* one world of four gloo ranks on a ``file://`` store
  (``mesh_worlds``, a 2x2 mesh) for the module: the same matrix on the
  mesh against the reference's emulation at D=2, with
  ``collective_floats_per_chip == floats_by_direction("worker->master")
  * m/T`` and data-axis floats > 0 (the Gram cache's ``L (p^2 + p)`` and
  raw ProxGD's ``p L`` a round by the reference's rule); and the
  stochastic solvers, where the 2-D mesh equals the port's emulation at
  the same ``data_shards`` bit for bit and the ledger is the 1-D one
  (tests/test_stochastic.py:291-299).
"""
import os
import pathlib
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")
sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1] / "src_torch"))

import jax.numpy as jnp  # noqa: E402

import mesh_worlds as mw  # noqa: E402
import repro  # noqa: E402
from repro.core import worker_ops as jwo  # noqa: E402
from repro.core.methods import MTLProblem as JProblem  # noqa: E402
import repro_torch  # noqa: E402
from repro_torch.core import worker_ops as two  # noqa: E402
from repro_torch.runtime import SimRuntime  # noqa: E402

W_RTOL = 1e-4        # DESIGN.md §3's solver bound, as in test_torch_solvers
T, D = 2, 2          # the world's mesh


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    return mw.launch("2d", tmp_path_factory.mktemp("mesh2d"))


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


IDS = [f"{t}-{n}" for t, _, n, _ in mw.MATRIX]


# ---------------------------------------------------------------------------
# the simulated cluster's 2-D emulation, in this process
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("tag,kind,name,kw", mw.MATRIX, ids=IDS)
def test_sim_emulation_matches_reference_at_four_shards(tag, kind, name, kw):
    rj = _ref(kind, name, kw, data_shards=4)
    rt = repro_torch.solve(mw._problem(kind), method=name, data_shards=4,
                           device="cpu", **mw.hyper(kind, name, kw))
    _close(rt.W, rj.W)
    assert rt.comm.ledger() == rj.comm.ledger()
    assert rt.rounds_axis == rj.rounds_axis
    assert rt.extras["data_shards"] == 4
    # the emulation moves no bytes on either axis
    assert rt.extras["collective_floats_per_chip"] == 0
    assert rt.extras["data_collective_floats_per_chip"] == 0


@pytest.mark.parametrize("shards", [2, 4, 8])
def test_sharded_gram_matches_the_reference(shards):
    rng = np.random.default_rng(0)
    X = rng.standard_normal((6, 40, 12)).astype(np.float32)
    y = rng.standard_normal((6, 40)).astype(np.float32)
    Aj, bj = jwo.gram_stats(jnp.asarray(X), jnp.asarray(y),
                            data_shards=shards)
    A, b = two.gram_stats(torch.from_numpy(X), torch.from_numpy(y),
                          data_shards=shards)
    np.testing.assert_allclose(A.numpy(), np.asarray(Aj), atol=1e-5, rtol=1e-5)
    np.testing.assert_allclose(b.numpy(), np.asarray(bj), atol=1e-5, rtol=1e-5)
    A1, _ = two.gram_stats(torch.from_numpy(X), torch.from_numpy(y))
    np.testing.assert_allclose(A.numpy(), A1.numpy(), atol=1e-5, rtol=1e-5)


def test_bad_shard_counts_raise():
    X, y, _ = mw.arrays("sq")
    from repro_torch.core.methods import MTLProblem
    prob = MTLProblem.make(X[:, :10], y[:, :10], "squared", device="cpu")
    with pytest.raises(ValueError, match="divisible by data_shards"):
        repro_torch.solve(prob, method="proxgd", rounds=2, data_shards=3,
                          device="cpu")
    with pytest.raises(ValueError, match="divisible by\\s+data_shards=2"):
        repro_torch.solve(prob, method="proxgd", rounds=2, data_shards=2,
                          batch_size=3, local_steps=2, device="cpu")
    with pytest.raises(ValueError, match="not divisible by data_shards"):
        two.gram_stats(prob.Xs, prob.ys, data_shards=3)


def test_sim_emulation_is_deterministic_and_samples_per_shard():
    """Two emulated runs agree bit for bit, and the shards draw their own
    rows (the folded shard index): the 2-D draws differ from the 1-D
    ones while the ledger does not."""
    prob = mw._problem("sgd")
    kw = dict(method="proxgd", lam=0.02, rounds=3, device="cpu",
              **mw.SGD_KW)
    a = repro_torch.solve(prob, data_shards=2, **kw)
    b = repro_torch.solve(prob, data_shards=2, **kw)
    one = repro_torch.solve(prob, **kw)
    assert torch.equal(a.W, b.W)
    assert not torch.equal(a.W, one.W)
    assert a.comm.ledger() == one.comm.ledger()


def test_sim_emulation_refuses_shards_at_different_collectives():
    prob = mw._problem("sq")
    rt = SimRuntime(prob, data_shards=2)

    def body(k, state, data):
        if rt.data_index() == 0:
            rt.psum_data(data["Xs"].sum(), "only shard 0")
        return state

    with pytest.raises(RuntimeError, match="different collectives"):
        rt.run_rounds(1, body, {})


def test_lockstep_keeps_every_collective_whole_under_stress():
    """More shard threads than cores and a very short switch interval:
    every one of many sums and gathers sees each shard's operand once,
    in shard order, and the run ends inside its time limit."""
    import threading
    from repro_torch.runtime.sim import _Lockstep
    shards, rounds = 2 * (os.cpu_count() or 8), 30
    lockstep = _Lockstep(shards)

    def shard(d):
        seen = []
        for k in range(rounds):
            s = lockstep.meet(d, "psum", torch.tensor([float(d + k)]),
                              lambda xs: torch.stack(xs).sum(0))
            g = lockstep.meet(d, "all_gather", torch.tensor([d]),
                              lambda xs: torch.cat(xs))
            seen.append((float(s), g.tolist()))
        return seen

    box = {}
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        t = threading.Thread(target=lambda: box.update(out=lockstep.run(shard)))
        t.start()
        t.join(timeout=120)
        assert not t.is_alive(), "the shards deadlocked"
    finally:
        sys.setswitchinterval(old)
    want = [(float(sum(range(shards)) + shards * k), list(range(shards)))
            for k in range(rounds)]
    assert box["out"] == [want] * shards


def test_lockstep_shards_own_their_results():
    """A shard that writes in place into what a collective gave it
    changes no other shard's result: shard 0 runs on past the sum before
    the others read theirs."""
    from repro_torch.runtime.sim import _Lockstep
    lockstep = _Lockstep(3)

    def shard(d):
        s = lockstep.meet(d, "psum", torch.ones(2) * (d + 1),
                          lambda xs: torch.stack(xs).sum(0))
        seen = s.tolist()
        s.mul_(0.0)
        lockstep.meet(d, "psum", torch.zeros(1), lambda xs: xs[0])
        return seen

    assert lockstep.run(shard) == [[6.0, 6.0]] * 3


# ---------------------------------------------------------------------------
# the 2x2 mesh
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("tag,kind,name,kw", mw.MATRIX, ids=IDS)
def test_mesh2d_matches_reference(world, tag, kind, name, kw):
    row = world["mesh"][tag, name]
    rj = _ref(kind, name, kw, data_shards=D)
    _close(row["W"], rj.W)
    assert row["ledger"] == rj.comm.ledger()
    assert row["summary"] == rj.comm.summary()
    assert row["rounds_axis"] == rj.rounds_axis
    assert row["n_iterates"] == len(rj.iterates)
    m = mw.SPECS[kind]["m"]
    assert row["coll"] == rj.comm.floats_by_direction("worker->master") \
        * (m // T)
    assert row["shards"] == D and row["agree"]
    assert row["dcoll"] > 0
    # the port's own emulation at the same shard count, in the same world
    sim = world["sim"][tag, name]
    assert sim["ledger"] == row["ledger"] and sim["dcoll"] == 0
    _close(row["W"], sim["W"].numpy())


def test_mesh2d_data_floats_by_the_references_rule(world):
    p, m = mw.SPECS["sq"]["p"], mw.SPECS["sq"]["m"]
    L = m // T
    assert world["analytic"]["dgsp"] == L * (p * p + p)
    assert world["analytic"]["proxgd_raw"] == 6 * p * L


@pytest.mark.parametrize("method", mw.STOCHASTIC)
def test_mesh2d_stochastic_matches_sim2d_bitwise(world, method):
    sim2, mesh2, sim1 = world["sgd"][method]
    assert torch.equal(sim2["W"], mesh2["W"]) and mesh2["agree"]
    assert sim2["ledger"] == mesh2["ledger"]
    assert sim1["ledger"] == sim2["ledger"]      # layout-invariant ledger
    full, degen = world["degen"][method]
    assert torch.equal(full["W"], degen["W"])
    assert full["ledger"] == degen["ledger"]


def test_mesh2d_refusals_are_the_references(world):
    ref = world["refusals"]
    assert "n=45 samples per task must be divisible by data_shards=2" \
        in ref["n"]
    assert "data_shards=4 contradicts the mesh's 'data' axis of size 2" \
        in ref["contradicts"]


def test_mesh2d_groups_time_out_as_init_cluster_set(world):
    assert world["timeouts"] == {"tasks": mw.TIMEOUT_S, "data": mw.TIMEOUT_S}


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
def test_mesh_2d_recovery_and_resumed_bitidentical(world, tag):
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
    rj = repro.solve(ref_problem(), data_shards=D, **mw.RECOVERY[tag])
    _close(row["res"]["W"], rj.W)
    assert row["res"]["ledger"] == rj.comm.ledger()


def test_mesh2d_static_verify(world):
    """``repro_torch.analysis`` on the 2x2 layout: every cell of the
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
        [(m, "mesh2d", "scan") for m in labels]
    sim = mw.sim_charges()
    for c in cases:
        assert (c["charged_floats_per_machine"],
                c["charged_vectors_per_round"]) == sim[c["method"]], \
            c["method"]
    assert v["static_verify"] == "ok" and v["bitwise"] and v["ledger_equal"]
    assert "COMM001" in v["refused"] and "c10d.allreduce_" in v["refused"]
    assert "'tasks'" in v["refused"] and "floats" in v["refused"]
