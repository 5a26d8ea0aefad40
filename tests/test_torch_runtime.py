"""The port's protocol runtime (``repro_torch.runtime``) and ledger
(``repro_torch.core.comm``) against the JAX reference, on the CPU.

Ledgers compare with ``==`` (exact), iterates of the two drivers with
``torch.equal`` (the port runs one loop for both, so bit-identical)."""
import datetime
import pathlib
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")
sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1] / "src_torch"))

import jax.numpy as jnp  # noqa: E402

from repro.core import comm as jcomm  # noqa: E402
from repro.core.methods import MTLProblem as JProblem  # noqa: E402
from repro.runtime.base import RecordSpec as JRecordSpec  # noqa: E402
from repro.runtime.sim import SimRuntime as JSim  # noqa: E402
import repro_torch  # noqa: E402
from repro_torch.core import comm as tcomm  # noqa: E402
from repro_torch.interop import problem_from_numpy  # noqa: E402
from repro_torch.runtime import RecordSpec, SimRuntime, make_runtime  # noqa: E402

M, N, P = 6, 20, 8


def _arrays(seed=0):
    rng = np.random.default_rng(seed)
    X = rng.standard_normal((M, N, P)).astype(np.float32)
    y = rng.standard_normal((M, N)).astype(np.float32)
    return X, y


def _problems(gram=True):
    X, y = _arrays()
    jp = JProblem.make(jnp.asarray(X), jnp.asarray(y), "squared", gram=gram)
    tp = problem_from_numpy(X, y, "squared", gram=gram, device="cpu")
    return jp, tp


def test_commlog_ledger_and_summaries_match():
    logs = [mod.CommLog(m=5) for mod in (jcomm, tcomm)]
    for log in logs:
        for rnd in range(3):
            log.begin_round()
            log.send("worker->master", 1, 40, "gradient column")
            log.send("master->worker", 2, 40, "basis")
        log.send("worker->master", 7, 41, "ship all local data")
    j, t = logs
    assert t.ledger() == j.ledger()
    assert t.summary() == j.summary()
    assert t.total_floats() == j.total_floats()
    for d in ("worker->master", "master->worker"):
        assert t.floats_by_direction(d) == j.floats_by_direction(d)
    assert tcomm.TABLE1_VECTORS_PER_ROUND == jcomm.TABLE1_VECTORS_PER_ROUND


def _exchange_body(rt, ones, zeros):
    """One round through every primitive, with the reference's shapes."""
    def body(k, state, data):
        G = rt.gather_columns(zeros((P, M)), "gradient column")
        rt.gather_tasks(zeros((M, N, P + 1)), "ship all local data")
        rt.sum_tasks(zeros((M, 3, P)), "moments")
        rt.broadcast(ones((P,)), "vector")
        rt.broadcast(G, "columns")
        rt.broadcast(zeros((P, 3)), "basis")
        rt.broadcast(zeros((2, 3, P)), "stack")
        rt.broadcast(zeros((P, 3)), "override", vectors=3, dim=P)
        return state
    return body


def test_primitives_charge_as_the_reference():
    jp, tp = _problems()
    jrt, trt = JSim(jp), SimRuntime(tp)
    jrt.run_rounds(3, _exchange_body(jrt, jnp.ones, jnp.zeros),
                   {"W": jnp.zeros((P, M))}, scan=False)
    trt.run_rounds(3, _exchange_body(trt, torch.ones, torch.zeros),
                   {"W": torch.zeros(P, M)})
    assert trt.comm.ledger() == jrt.comm.ledger()
    assert trt.comm.rounds == jrt.comm.rounds == 3
    assert trt.collective_floats_per_chip == jrt.collective_floats_per_chip == 0
    with pytest.raises(ValueError, match="both"):
        trt.broadcast(torch.zeros(P), vectors=1)


def test_sum_tasks_and_worker_map():
    _, tp = _problems()
    rt = SimRuntime(tp)
    x = torch.arange(M * 3, dtype=torch.float32).reshape(M, 3)
    assert torch.equal(rt.sum_tasks(x), x.sum(0))
    f = rt.worker_map(lambda a, b: a * b.sum(), in_axes=(0, 1))
    B = torch.ones(4, M)
    assert torch.equal(f(x, B), x * 4.0)


@pytest.mark.parametrize("method,kw", [
    ("proxgd", {"lam": 0.02, "rounds": 5}),
    ("admm", {"lam": 0.02, "rounds": 4}),
    ("dgsp", {"rounds": 4}),
])
def test_eager_and_scan_are_identical(method, kw):
    _, tp = _problems()
    a = repro_torch.solve(tp, method=method, scan=False, device="cpu", **kw)
    b = repro_torch.solve(tp, method=method, scan=True, device="cpu", **kw)
    assert torch.equal(a.W, b.W)
    assert a.comm.ledger() == b.comm.ledger()
    assert a.rounds_axis == b.rounds_axis
    assert all(torch.equal(x, y) for x, y in zip(a.iterates, b.iterates))


@pytest.mark.parametrize("every,rounds", [(1, 5), (2, 7), (3, 9), (10, 4)])
def test_record_spec_cadence_matches(every, rounds):
    assert RecordSpec(sink=None, every=every).snap_rounds(rounds) == \
        JRecordSpec(sink=None, every=every).snap_rounds(rounds)


def test_solver_records_on_the_reference_cadence():
    jp, tp = _problems()
    import repro
    kw = dict(method="proxgd", lam=0.02, rounds=7, record_every=3)
    rj = repro.solve(jp, **kw)
    rt = repro_torch.solve(tp, device="cpu", **kw)
    assert rt.rounds_axis == rj.rounds_axis == [0, 3, 6, 7]
    assert len(rt.iterates) == 4


@pytest.mark.parametrize("count", [True, False])
def test_one_shot(count):
    _, tp = _problems()
    rt = SimRuntime(tp)

    def body(k, state, data):
        assert k == 0 and set(data) == {"gram_A", "gram_b"}
        return {"W": rt.broadcast(rt.gather_columns(state["W"] + 1.0, "w"),
                                  "back")}

    out = rt.one_shot(body, {"W": torch.zeros(P, M)}, count_round=count,
                      data_leaves=("gram_A", "gram_b"))
    assert torch.equal(out["W"], torch.ones(P, M))
    assert rt.comm.rounds == (1 if count else 0)
    assert rt.comm.ledger() == [(int(count), "worker->master", 1, P, "w"),
                                (int(count), "master->worker", 1, P, "back")]


def test_a_runtime_serves_one_solve():
    _, tp = _problems()
    rt = SimRuntime(tp)
    body = _exchange_body(rt, torch.ones, torch.zeros)
    rt.run_rounds(1, body, {})
    with pytest.raises(RuntimeError, match="cannot be reused"):
        rt.run_rounds(1, body, {})


def test_a_round_that_charges_differently_raises():
    _, tp = _problems()
    rt = SimRuntime(tp)

    def body(k, state, data):
        rt.gather_columns(torch.zeros(P, M), "gradient column")
        if k == 2:
            rt.broadcast(torch.zeros(P), "an extra vector")
        return state

    with pytest.raises(RuntimeError, match="round 2 charged"):
        rt.run_rounds(4, body, {})


def test_make_runtime_names_what_is_not_ported(tmp_path):
    """Both backends and the data axis are ported: "sim" with
    ``data_shards`` gives the 2-D emulation, "mesh" a MeshRuntime over the
    process group (here a gloo group of this process alone), and "mesh"
    without a group says how to start one."""
    import mesh_worlds
    from repro_torch.runtime import MeshRuntime
    _, tp = _problems()
    assert isinstance(make_runtime("sim", tp), SimRuntime)
    rt = make_runtime("sim", tp, data_shards=2)
    assert isinstance(rt, SimRuntime) and rt.data_shards == 2
    with pytest.raises(RuntimeError, match="init_cluster"):
        make_runtime("mesh", tp)
    with mesh_worlds.one_rank_group(tmp_path):
        rt = make_runtime("mesh", tp)
        assert isinstance(rt, MeshRuntime)
        assert (rt.local_tasks, rt.data_index(), rt.data_shards) == (M, 0, 1)
    with pytest.raises(ValueError, match="unknown backend"):
        make_runtime("tpu", tp)


def test_mesh_refuses_a_group_init_cluster_did_not_start(tmp_path):
    """The mesh's subgroups take the timeout ``init_cluster`` gave the
    world group; a group started some other way has none to give."""
    import torch.distributed as dist
    _, tp = _problems()
    dist.init_process_group("gloo", init_method=f"file://{tmp_path}/store",
                            world_size=1, rank=0,
                            timeout=datetime.timedelta(seconds=60))
    try:
        with pytest.raises(RuntimeError, match="not started by init_cluster"):
            make_runtime("mesh", tp)
    finally:
        dist.destroy_process_group()
