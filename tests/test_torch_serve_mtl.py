"""The port's factored server (``repro_torch.serve.mtl``) against the JAX
reference on the same factors and requests, on the CPU: carried models,
onboarding, scores for every code table, stores loaded both ways, and
the reload that skips a damaged store step.

Scores are held to 1e-4 absolute and 1e-5 relative, the reference's own
tolerance between its served paths (``tests/test_mtl_score.py``)."""
import os
import pathlib
import sys
import warnings

import numpy as np
import pytest

torch = pytest.importorskip("torch")
sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1] / "src_torch"))

import jax.numpy as jnp  # noqa: E402

from repro.obs.metrics import MetricsRegistry as JRegistry  # noqa: E402
from repro.serve import mtl as jserve  # noqa: E402
from repro_torch import resolve_device  # noqa: E402
from repro_torch.interop import factored_from_numpy  # noqa: E402
from repro_torch.obs.metrics import MetricsRegistry as TRegistry  # noqa: E402
from repro_torch.serve import mtl as tserve  # noqa: E402

TOL = dict(atol=1e-4, rtol=1e-5)
CPU = "cpu"


def _factors(p=40, m=16, r=3, seed=0):
    rng = np.random.default_rng(seed)
    U = np.linalg.qr(rng.standard_normal((p, r)))[0].astype(np.float32)
    s = np.linspace(2.0, 1.0, r).astype(np.float32)
    V = rng.standard_normal((m, r)).astype(np.float32)
    return U, s, V


def _pair(loss="squared", keys=False, **kw):
    U, s, V = _factors(**kw)
    task_keys = tuple(f"task-{j}" for j in range(V.shape[0])) if keys else None
    jm = jserve.FactoredModel(U=jnp.asarray(U), s=jnp.asarray(s),
                              V=jnp.asarray(V), loss=loss, task_keys=task_keys)
    tm = factored_from_numpy(np.asarray(jm.U), np.asarray(jm.s),
                             np.asarray(jm.V), loss=loss, task_keys=task_keys,
                             device=CPU)
    return jm, tm


def _requests(n, m, p, seed=1):
    rng = np.random.default_rng(seed)
    return (rng.integers(0, m, n).astype(np.int32),
            rng.standard_normal((n, p)).astype(np.float32))


@pytest.mark.parametrize("keys", [False, True])
@pytest.mark.parametrize("loss", ["squared", "logistic"])
def test_carried_model_keeps_version_and_codes(keys, loss):
    jm, tm = _pair(loss=loss, keys=keys)
    assert tm.version == jm.version
    assert (tm.p, tm.m, tm.rank) == (jm.p, jm.m, jm.rank)
    np.testing.assert_array_equal(tm.codes.numpy(), np.asarray(jm.codes))
    np.testing.assert_allclose(tm.dense().numpy(), np.asarray(jm.dense()),
                               atol=1e-6)
    assert tm.manifest() == jm.manifest()


def test_from_W_matches_jax():
    rng = np.random.default_rng(3)
    W = (rng.standard_normal((64, 4)) @ rng.standard_normal((4, 40))
         + 1e-3 * rng.standard_normal((64, 40))).astype(np.float32)
    jm = jserve.FactoredModel.from_W(W, 4)
    tm = tserve.FactoredModel.from_W(W, 4, device=CPU)
    np.testing.assert_allclose(tm.s.numpy(), np.asarray(jm.s), rtol=1e-5)
    np.testing.assert_allclose(tm.dense().numpy(), np.asarray(jm.dense()),
                               atol=1e-4 * float(jm.s[0]))


@pytest.mark.parametrize("loss", ["squared", "logistic"])
def test_onboard_code_matches_jax(loss):
    U, _, _ = _factors(p=40, r=3)
    rng = np.random.default_rng(4)
    X = rng.standard_normal((12, 40)).astype(np.float32)
    y = rng.standard_normal(12).astype(np.float32)
    if loss == "logistic":
        y = np.where(y > 0, 1.0, -1.0).astype(np.float32)
    want = np.asarray(jserve.onboard_code(jnp.asarray(U), X, y, loss=loss))
    got = tserve.onboard_code(torch.from_numpy(U), X, y, loss=loss).numpy()
    np.testing.assert_allclose(got, want, **TOL)


@pytest.mark.parametrize("code_dtype", ["f32", "int8", "fp8"])
def test_server_scores_match_jax(code_dtype):
    """Three waves of 8 with a ragged last wave (23 requests)."""
    jm, tm = _pair()
    ids, X = _requests(23, jm.m, jm.p)
    want, jv = jserve.MTLServer(jm, batch_size=8, code_dtype=code_dtype,
                                registry=JRegistry()).score(ids, X)
    got, tv = tserve.MTLServer(tm, batch_size=8, code_dtype=code_dtype,
                               registry=TRegistry()).score(ids, X)
    assert tv == jv and got.shape == (23,) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_score_batch_matches_jax():
    jm, tm = _pair()
    ids, X = _requests(10, jm.m, jm.p)
    want, jok = jserve._score_batch(jm.U, jm.codes, ids, X, jm.m)
    got, tok = tserve._score_batch(tm.U, tm.codes, torch.from_numpy(ids),
                                   torch.from_numpy(X), tm.m)
    assert bool(tok) and bool(jok)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_predict_logistic_matches_jax():
    jm, tm = _pair(loss="logistic")
    ids, X = _requests(13, jm.m, jm.p, seed=2)
    want, _ = jserve.MTLServer(jm, batch_size=8,
                               registry=JRegistry()).predict(ids, X)
    got, _ = tserve.MTLServer(tm, batch_size=8,
                              registry=TRegistry()).predict(ids, X)
    assert float(got.min()) >= 0.0 and float(got.max()) <= 1.0
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)


def test_score_keyed_matches_jax():
    jm, tm = _pair(keys=True)
    keys = [f"task-{j}" for j in (0, 3, 15, 7, 2, 9, 11)]
    _, X = _requests(len(keys), jm.m, jm.p)
    want, _ = jserve.MTLServer(jm, batch_size=4,
                               registry=JRegistry()).score_keyed(keys, X)
    ts = tserve.MTLServer(tm, batch_size=4, registry=TRegistry())
    got, _ = ts.score_keyed(keys, X)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    assert ts.resolve("task-9") == 9
    with pytest.raises(ValueError, match="unknown task key"):
        ts.score_keyed(["nope"], X[:1])


@pytest.mark.parametrize("code_dtype", ["f32", "int8"])
def test_onboarded_task_scores_match_jax(code_dtype):
    jm, tm = _pair(keys=True)
    rng = np.random.default_rng(5)
    Xf = rng.standard_normal((12, jm.p)).astype(np.float32)
    yf = rng.standard_normal(12).astype(np.float32)
    js = jserve.MTLServer(jm, batch_size=8, code_dtype=code_dtype,
                          registry=JRegistry())
    ts = tserve.MTLServer(tm, batch_size=8, code_dtype=code_dtype,
                          registry=TRegistry())
    assert js.onboard("new", Xf, yf) == ts.onboard("new", Xf, yf) == jm.m
    assert ts.model.m == jm.m + 1 and ts.model.task_keys[-1] == "new"
    ids = np.asarray([jm.m] * 5 + [0, 3], np.int32)
    _, X = _requests(7, jm.m, jm.p, seed=6)
    want, _ = js.score(ids, X)
    got, _ = ts.score(ids, X)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **TOL)
    with pytest.raises(ValueError, match="already onboarded"):
        ts.onboard("new", Xf, yf)


@pytest.mark.parametrize("bad", [[-1], [16], [3, 19, 0]])
def test_invalid_ids_raise_and_count(bad):
    _, tm = _pair()
    reg = TRegistry()
    server = tserve.MTLServer(tm, batch_size=2, registry=reg)
    _, X = _requests(len(bad), tm.m, tm.p)
    with pytest.raises(ValueError, match="task ids outside"):
        server.score(np.asarray(bad, np.int32), X)
    assert reg.counter("serve_invalid_batches_total").value == 1
    assert reg.counter("serve_requests_total").value == 0


def test_slo_counters_match_jax():
    jm, tm = _pair()
    jr, tr = JRegistry(), TRegistry()
    js = jserve.MTLServer(jm, batch_size=8, registry=jr, swap_log_limit=2)
    ts = tserve.MTLServer(tm, batch_size=8, registry=tr, swap_log_limit=2)
    for n in (5, 8, 23):
        ids, X = _requests(n, jm.m, jm.p, seed=n)
        js.score(ids, X)
        ts.score(ids, X)
    for _ in range(3):
        js.swap(jm)
        ts.swap(tm)
    for name in ("serve_requests_total", "serve_waves_total",
                 "serve_swaps_total", "serve_invalid_batches_total"):
        assert tr.counter(name).value == jr.counter(name).value, name
    assert tr.histogram("serve_latency_seconds").count == 3
    assert [v for _, v in ts.swap_log] == [v for _, v in js.swap_log]


def test_store_cross_loads_both_ways(tmp_path):
    store = str(tmp_path / "store")
    jm, _ = _pair(keys=True)
    assert jm.save(store) == 0
    step, tm = tserve.FactoredModel.load(store, device=CPU)
    assert step == 0 and tm.version == jm.version
    np.testing.assert_array_equal(tm.U.numpy(), np.asarray(jm.U))
    rng = np.random.default_rng(7)
    grown = tm.onboard("extra", rng.standard_normal((6, tm.p)),
                       rng.standard_normal(6))
    assert grown.save(store) == 1
    step, back = jserve.FactoredModel.load(store)
    assert step == 1 and back.version == grown.version
    assert back.task_keys == grown.task_keys
    np.testing.assert_array_equal(np.asarray(back.V), grown.V.numpy())


def test_maybe_reload_skips_a_damaged_newest_step(tmp_path):
    store = str(tmp_path / "store")
    models = [_pair(seed=k)[1] for k in range(3)]
    for k, model in enumerate(models):
        assert model.save(store) == k
    newest = os.path.join(store, "step_00000002.npz")
    with open(newest, "r+b") as f:                 # truncate mid-file
        f.truncate(os.path.getsize(newest) // 2)
    server = tserve.MTLServer(models[0], batch_size=4, registry=TRegistry())
    server.swap(models[0], step=0)
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        assert server.maybe_reload(store, retries=1, backoff_s=0.0)
    assert any("step 2" in str(w.message) for w in caught)
    assert server.version == models[1].version
    assert not server.maybe_reload(store, retries=0)   # nothing newer verifies


def test_default_device_is_the_card():
    if torch.cuda.is_available():
        assert resolve_device(None).type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="CUDA"):
            resolve_device(None)
        U, s, V = _factors()
        with pytest.raises(RuntimeError, match="CUDA"):
            factored_from_numpy(U, s, V)
    assert resolve_device("cpu").type == "cpu"


def test_mesh_is_not_ported_yet():
    """The sharded table is ported (tests/test_torch_mesh.py runs it on
    four ranks); a mesh= that is no DeviceMesh is refused by name."""
    _, tm = _pair()
    with pytest.raises(TypeError, match="DeviceMesh with a 'tasks' axis"):
        tserve.MTLServer(tm, mesh=object())
