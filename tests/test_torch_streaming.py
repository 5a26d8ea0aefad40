"""The closed train -> serve loop in the port (``repro_torch.train.
streaming``), on the CPU, against the JAX reference
(tests/test_streaming.py:41-216).

Pass criteria:
* ``SampleStream``: shapes and determinism; its key chain, uniform draws
  and labels equal ``jax.random``'s bitwise under the same seed and tick,
  its normal draws within ``1e-6 * max(1, |x|)``, its samples within
  ``1e-5 * max(1, |x|)`` (the Cholesky factor and the product round);
* ``ReservoirBuffer``: shapes stay fixed, new samples are absorbed, the
  survivors are uniform over the stream, and on the same draws its slot
  choices and buffers equal the reference's bitwise;
* the loop publishes each refresh to a live ``MTLServer``, warm-starts
  from the previous solution, refuses full-batch-only solvers, keeps the
  swap log and staleness gauges, and its background thread starts, stops
  and refuses a second start with every join bounded;
* one refresh on the same draws as the reference's: the published W
  within the solver bound ``1e-4 * max(1, max|W|)``, the same store step
  (the published version number).
"""
import pathlib
import sys
import threading
import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")
sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1] / "src_torch"))

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import repro  # noqa: E402
from repro.core.methods import MTLProblem as JProblem  # noqa: E402
from repro.data.synthetic import SimSpec, generate  # noqa: E402
from repro.serve.mtl import MTLServer as JServer  # noqa: E402
from repro.train import streaming as jstream  # noqa: E402
import repro_torch  # noqa: E402
from repro_torch.core import prng  # noqa: E402
from repro_torch.core.methods import MTLProblem  # noqa: E402
from repro_torch.obs.metrics import MetricsRegistry  # noqa: E402
from repro_torch.serve.mtl import FactoredModel, MTLServer  # noqa: E402
from repro_torch.train.streaming import (ReservoirBuffer, SampleStream,  # noqa: E402
                                         StreamingResolver)

SPEC = SimSpec(p=12, m=6, r=2, n=16)            # tests/test_streaming.py:27
HP = {"lam": 0.01}
W_RTOL = 1e-4
JOIN_S = 60                                     # every join in this file


@pytest.fixture(scope="module")
def world():
    Xs, ys, Wstar, Sigma = generate(jax.random.PRNGKey(0), SPEC)
    arrays = [np.asarray(a) for a in (Xs, ys, Wstar, Sigma)]
    prob = MTLProblem.make(arrays[0], arrays[1], r=SPEC.r, device="cpu")
    return prob, arrays


def _stream(world, **kw):
    _, (_, _, Wstar, Sigma) = world
    return SampleStream(Wstar, Sigma, device="cpu", **kw)


# ---------------------------------------------------------------------------
# SampleStream
# ---------------------------------------------------------------------------
def test_stream_shapes_and_determinism(world):
    s1, s2 = _stream(world, seed=5), _stream(world, seed=5)
    X1, y1 = s1.draw(7)
    X2, y2 = s2.draw(7)
    assert X1.shape == (SPEC.m, 7, SPEC.p) and y1.shape == (SPEC.m, 7)
    assert torch.equal(X1, X2) and torch.equal(y1, y2)
    X3, _ = s1.draw(7)
    assert not torch.equal(X1, X3)
    X4, _ = _stream(world, seed=6).draw(7)
    assert not torch.equal(X1, X4)
    assert X1.device.type == "cpu"


@pytest.mark.parametrize("task", ["regression", "classification"])
def test_stream_draws_are_jax_randoms(world, task):
    _, (_, _, Wstar, Sigma) = world
    port = _stream(world, seed=5, task=task)
    ref = jstream.SampleStream(Wstar, Sigma, seed=5, task=task)
    m, p, count = SPEC.m, SPEC.p, 9
    for tick in range(3):
        Xt, yt = port.draw(count)
        Xj, yj = (np.asarray(a) for a in ref.draw(count))
        # the key chain and the raw draws under this seed and tick
        kx, ky = jax.random.split(jax.random.fold_in(
            jax.random.PRNGKey(5), tick))
        tkx, tky = prng.split(prng.fold_in(prng.PRNGKey(5, device="cpu"),
                                           tick))
        np.testing.assert_array_equal(tkx.numpy().astype(np.uint32),
                                      np.asarray(kx))
        np.testing.assert_array_equal(tky.numpy().astype(np.uint32),
                                      np.asarray(ky))
        Zj = np.asarray(jax.random.normal(kx, (m, count, p)))
        Zt = prng.normal(tkx, (m, count, p)).numpy()
        assert np.all(np.abs(Zt - Zj) <= 1e-6 * np.maximum(1, np.abs(Zj)))
        # the samples: the Cholesky factor and the product round
        assert np.all(np.abs(Xt.numpy() - Xj)
                      <= 1e-5 * np.maximum(1, np.abs(Xj)))
        if task == "regression":
            assert np.all(np.abs(yt.numpy() - yj)
                          <= 1e-5 * np.maximum(1, np.abs(yj)))
        else:
            uj = np.asarray(jax.random.uniform(ky, (m, count)))
            ut = prng.uniform(tky, (m, count)).numpy()
            np.testing.assert_array_equal(ut, uj)
            assert set(np.unique(yt.numpy())) <= {-1.0, 1.0}
            np.testing.assert_array_equal(yt.numpy(), yj)


# ---------------------------------------------------------------------------
# ReservoirBuffer
# ---------------------------------------------------------------------------
def test_reservoir_shapes_stay_fixed(world):
    prob, _ = world
    buf = ReservoirBuffer(prob.Xs, prob.ys, seed=1)
    stream = _stream(world, seed=2)
    for _ in range(3):
        buf.add(*stream.draw(9))
    assert buf.Xs.shape == (prob.m, prob.n, prob.p)
    assert buf.seen == prob.n + 27
    prob2 = buf.problem(prob)
    assert prob2.Xs.shape == prob.Xs.shape and prob2.device == prob.device
    assert prob2.loss.name == prob.loss.name
    assert (prob2.r, prob2.A, prob2.l2) == (prob.r, prob.A, prob.l2)
    assert (prob2.gram_A is not None) == (prob.gram_A is not None)


def test_reservoir_absorbs_new_samples(world):
    prob, _ = world
    buf = ReservoirBuffer(prob.Xs, prob.ys, seed=1)
    before = buf.Xs.copy()
    stream = _stream(world, seed=2)
    kept = sum(buf.add(*stream.draw(16)) for _ in range(4))
    assert kept > 0
    assert not np.array_equal(before, buf.Xs)


def test_reservoir_is_uniform_over_the_stream(world):
    """Algorithm R: after streaming 3 x cap samples past a cap-slot
    reservoir, about a quarter of the survivors are seed rows."""
    prob, _ = world
    cap = prob.n
    Xs0 = np.full((prob.m, cap, prob.p), 1000.0)
    buf = ReservoirBuffer(Xs0, np.zeros((prob.m, cap)), seed=3)
    stream = _stream(world, seed=4)
    for _ in range(3):
        buf.add(*stream.draw(cap))
    frac = float(np.mean(buf.Xs[:, :, 0] == 1000.0))
    assert 0.05 < frac < 0.55, frac


def test_reservoir_slots_are_the_references(world):
    prob, (Xs, ys, Wstar, Sigma) = world
    port = ReservoirBuffer(prob.Xs, prob.ys, seed=7)
    ref = jstream.ReservoirBuffer(Xs, ys, seed=7)
    stream = jstream.SampleStream(Wstar, Sigma, seed=8)
    for count in (5, 16, 40):
        X, y = (np.asarray(a) for a in stream.draw(count))
        assert port.add(torch.from_numpy(X), y) == ref.add(X, y)
        np.testing.assert_array_equal(port.Xs, ref.Xs)
        np.testing.assert_array_equal(port.ys, ref.ys)
        assert port.seen == ref.seen


def test_reservoir_rejects_shape_mismatch(world):
    prob, _ = world
    buf = ReservoirBuffer(prob.Xs, prob.ys)
    with pytest.raises(ValueError, match="does not match"):
        buf.add(np.zeros((prob.m + 1, 2, prob.p)), np.zeros((prob.m + 1, 2)))


# ---------------------------------------------------------------------------
# the closed loop
# ---------------------------------------------------------------------------
def _serving_stack(prob, store, registry=None):
    res0 = repro_torch.solve(prob, method="proxgd", rounds=6,
                             keep_sv_carry=True, device="cpu", **HP)
    model0 = res0.factorize(prob.r)
    model0.save(store)
    return res0, MTLServer(model0, registry=registry)


def test_closed_loop_publishes_to_live_server(world, tmp_path):
    prob, _ = world
    store = str(tmp_path)
    res0, server = _serving_stack(prob, store)
    v0 = server.version
    stream = _stream(world, seed=3)
    resolver = StreamingResolver(
        prob, server, store, method="proxgd", rank=prob.r, rounds=4,
        batch_size=8, local_steps=2, warm_from=res0, solver_hp=HP)
    rep = resolver.step(stream, count=8)
    assert rep["reloaded"] and rep["warm_started"]
    assert server.version != v0
    assert rep["served_version"] == server.version
    assert rep["store_step"] == 1
    assert rep["staleness_oldest_s"] >= rep["staleness_newest_s"] >= 0.0
    assert rep["ingests_absorbed"] == 1
    # the server scores with the refreshed model
    X = torch.from_numpy(np.random.default_rng(0).standard_normal(
        (20, prob.p)).astype(np.float32))
    ids = torch.arange(20, dtype=torch.int32) % prob.m
    scores, ver = server.score(ids, X)
    own = (X * server.model.dense().index_select(1, ids.long()).T).sum(1)
    assert ver == rep["served_version"]
    assert float((scores - own).abs().max()) <= 1e-5 * float(own.abs().max())
    rep2 = resolver.step(stream, count=8)
    assert rep2["warm_started"] and rep2["store_step"] == 2
    assert resolver.history == [rep, rep2]


def test_warm_start_carries_previous_solution(world, tmp_path):
    prob, _ = world
    res0, _ = _serving_stack(prob, str(tmp_path))
    cold = StreamingResolver(prob, None, str(tmp_path), method="proxgd",
                             rounds=2, warm_start=False, solver_hp=HP)
    warm = StreamingResolver(prob, None, str(tmp_path), method="proxgd",
                             rounds=2, warm_from=res0, solver_hp=HP)
    assert warm._prev_W is not None and cold._prev_W is None
    assert warm._prev_sv is res0.extras["sv_carry"]
    X, y = _stream(world, seed=9).draw(4)
    cold.ingest(X, y)
    warm.ingest(X, y)
    rc, rw = cold.refresh(), warm.refresh()
    assert not rc["warm_started"] and rw["warm_started"]
    # the warm run's round-0 iterate IS the carried predictor matrix
    assert torch.equal(warm._last_result.iterates[0], res0.W)
    assert warm._prev_W is warm._last_result.W


def test_resolver_rejects_full_batch_only_methods(world):
    prob, _ = world
    with pytest.raises(ValueError, match="stochastic worker path"):
        StreamingResolver(prob, None, "unused", method="dfw")


def test_background_loop_lifecycle(world, tmp_path):
    prob, _ = world
    store = str(tmp_path)
    res0, server = _serving_stack(prob, store)
    stream = _stream(world, seed=13)
    resolver = StreamingResolver(
        prob, server, store, method="proxgd", rank=prob.r, rounds=3,
        batch_size=8, local_steps=2, warm_from=res0, solver_hp=HP)
    thread = resolver.start(stream, count=8, max_refreshes=2, interval_s=0.0)
    assert thread.daemon
    deadline = time.monotonic() + JOIN_S
    while len(resolver.history) < 2 and time.monotonic() < deadline:
        time.sleep(0.02)
    resolver.stop(timeout=JOIN_S)
    assert resolver.error is None
    assert len(resolver.history) == 2
    assert all(h["reloaded"] for h in resolver.history)
    # double start raises while running; restart after stop is fine
    resolver.start(stream, count=8, max_refreshes=3)
    with pytest.raises(RuntimeError, match="already running"):
        resolver.start(stream, count=8)
    resolver.stop(timeout=JOIN_S)
    assert resolver._thread is None


def test_stop_raises_when_the_thread_outlives_its_timeout(world, tmp_path):
    prob, _ = world
    gate = threading.Event()

    class SlowStream:
        def draw(self, count):
            gate.wait(JOIN_S)
            raise RuntimeError("stream closed")

    resolver = StreamingResolver(prob, None, str(tmp_path), method="proxgd",
                                 rounds=2, solver_hp=HP)
    resolver.start(SlowStream(), count=4)
    with pytest.raises(TimeoutError, match="did not finish"):
        resolver.stop(timeout=0.05)
    gate.set()
    with pytest.raises(RuntimeError, match="stream closed"):
        resolver.stop(timeout=JOIN_S)    # the loop's error surfaces
    assert resolver._thread is None


def test_swap_log_and_staleness_gauges(world, tmp_path):
    prob, _ = world
    store = str(tmp_path)
    reg = MetricsRegistry()
    res0, server = _serving_stack(prob, store, registry=reg)
    assert len(server.swap_log) == 1          # construction
    stream = _stream(world, seed=17)
    resolver = StreamingResolver(
        prob, server, store, method="proxgd", rank=prob.r, rounds=3,
        warm_from=res0, solver_hp=HP, registry=reg)
    reps = [resolver.step(stream, count=4) for _ in range(2)]
    assert len(server.swap_log) == 3
    times = [t for t, _ in server.swap_log]
    assert times == sorted(times)
    assert server.swap_log[-1][1] == server.version
    snap = reg.snapshot()["metrics"]
    assert snap["streaming_refreshes_total"]["value"] == 2
    old = snap["streaming_staleness_oldest_seconds"]["value"]
    new = snap["streaming_staleness_newest_seconds"]["value"]
    assert old == reps[-1]["staleness_oldest_s"] > 0
    assert new == reps[-1]["staleness_newest_s"] > 0
    assert snap["streaming_solve_seconds"]["value"] == reps[-1]["solve_s"] > 0


def test_one_refresh_matches_the_reference(world, tmp_path):
    """Both loops from their own offline solve of the same data, fed the
    same draw, with the same reservoir seed and batch seed."""
    prob, (Xs, ys, Wstar, Sigma) = world
    jprob = JProblem.make(jnp.asarray(Xs), jnp.asarray(ys), r=SPEC.r)
    kw = dict(method="proxgd", rank=SPEC.r, rounds=4, batch_size=8,
              local_steps=2, solver_hp=HP, buffer_seed=5)
    res0, server = _serving_stack(prob, str(tmp_path / "port"))
    jres0 = repro.solve(jprob, method="proxgd", rounds=6, keep_sv_carry=True,
                        **HP)
    jmodel0 = jres0.factorize(SPEC.r)
    jmodel0.save(str(tmp_path / "ref"))
    port = StreamingResolver(prob, server, str(tmp_path / "port"),
                             warm_from=res0, **kw)
    ref = jstream.StreamingResolver(jprob, JServer(jmodel0),
                                    str(tmp_path / "ref"), warm_from=jres0,
                                    **kw)
    X, y = (np.asarray(a) for a in jstream.SampleStream(
        Wstar, Sigma, seed=21).draw(8))
    port.ingest(X, y)
    ref.ingest(X, y)
    rt, rj = port.refresh(), ref.refresh()
    Wj = np.asarray(ref._last_result.W)
    tol = W_RTOL * max(1.0, float(np.abs(Wj).max()))
    assert float(np.abs(port._last_result.W.numpy() - Wj).max()) <= tol
    assert rt["store_step"] == rj["store_step"] == 1
    assert rt["reloaded"] and rj["reloaded"]
    assert (rt["warm_started"], rt["samples_seen"]) == \
        (rj["warm_started"], rj["samples_seen"])
    _, published = FactoredModel.load(str(tmp_path / "port"), device="cpu")
    jW = np.asarray(ref._last_result.factorize(SPEC.r).dense())
    assert float(np.abs(published.dense().numpy() - jW).max()) <= tol
