"""Device round metrics (``metrics=True``, ``repro_torch.obs.device``),
``read_events_jsonl`` and the ``python -m repro_torch.obs`` CLI, against
the JAX reference on the same numpy inputs (tests/test_obs.py:53-180).

Pass criteria:
* ``metrics=True`` leaves W and ``comm.ledger()`` bitwise equal to
  ``metrics=False`` on the sim (1-D and 2-D) and on a mesh of one gloo
  rank, and adds no collective float;
* the per-round arrays equal the reference's: ``round`` and the
  ``sv_exact`` flags exactly, ``objective``, ``grad_norm`` and
  ``step_norm`` within ``1e-5 * max(1, |v|)``, the per-round charged
  floats equal;
* the objective equals ``lam * ||W_k||_*`` recomputed from the iterates,
  to 1e-5 relative;
* a checkpointed (and a resumed) solve gives the same metrics bitwise;
* the metrics stay on the device until ``finalize`` reads them back.
"""
import json
import os
import pathlib
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")
ROOT = pathlib.Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src_torch"))

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

import repro  # noqa: E402
from repro.core.methods import MTLProblem as JProblem  # noqa: E402
from repro.data.synthetic import SimSpec, generate  # noqa: E402
from repro.obs import Tracer as JTracer  # noqa: E402
from repro.obs import read_events_jsonl as j_read_events  # noqa: E402
import repro_torch  # noqa: E402
from repro_torch.core.methods import MTLProblem  # noqa: E402
from repro_torch.obs import Tracer, read_events_jsonl  # noqa: E402
from repro_torch.obs.device import FIELDS, RoundMetricsSink  # noqa: E402

SPEC = SimSpec(p=10, m=8, r=2, n=24)            # tests/test_obs.py:33
BIG = SimSpec(p=24, m=16, r=3, n=30)            # the lazy engine engages
V_TOL = 1e-5
METHODS = {"proxgd": {"lam": 0.05}, "accproxgd": {"lam": 0.05},
           "admm": {"lam": 0.05}, "dfw": {}, "dgsp": {}, "dnsp": {},
           "altmin": {}}


def _pair(spec, key):
    Xs, ys, _, _ = generate(jax.random.PRNGKey(key), spec)
    jp = JProblem.make(Xs, ys, "squared", A=2.0, r=spec.r)
    tp = MTLProblem.make(np.asarray(Xs), np.asarray(ys), "squared", A=2.0,
                         r=spec.r, device="cpu")
    return jp, tp


@pytest.fixture(scope="module")
def probs():
    return _pair(SPEC, 0)


def _same(a, b):
    assert torch.equal(a.W, b.W)
    assert a.comm.ledger() == b.comm.ledger()
    for key in ("collective_floats_per_chip",
                "data_collective_floats_per_chip"):
        assert a.extras[key] == b.extras[key]


def _close_metrics(mt, mj):
    assert mt["round"].tolist() == np.asarray(mj["round"]).tolist()
    np.testing.assert_array_equal(mt["sv_exact"], np.asarray(mj["sv_exact"]))
    assert mt["sv_exact"].dtype == np.int32
    for f in ("objective", "grad_norm", "step_norm"):
        a, b = mt[f], np.asarray(mj[f])
        assert a.dtype == b.dtype == np.float32, f
        tol = V_TOL * np.maximum(1.0, np.abs(b))
        assert np.all(np.abs(a - b) <= tol), (f, a, b)
    assert mt["charged_floats_per_round"] == mj["charged_floats_per_round"]


@pytest.mark.parametrize("data_shards", [1, 2], ids=["1d", "2d"])
def test_metrics_leave_the_solve_bitwise_unchanged(probs, data_shards):
    _, tp = probs
    kw = dict(method="proxgd", rounds=5, lam=0.05, data_shards=data_shards,
              device="cpu")
    bare = repro_torch.solve(tp, **kw)
    inst = repro_torch.solve(tp, metrics=True, **kw)
    _same(bare, inst)
    assert "metrics" not in bare.extras
    assert inst.extras["metrics"]["round"].shape == (5,)


def test_metrics_on_the_mesh(probs, tmp_path):
    import mesh_worlds
    jp, tp = probs
    kw = dict(method="proxgd", rounds=5, lam=0.05, device="cpu")
    with mesh_worlds.one_rank_group(tmp_path):
        bare = repro_torch.solve(tp, backend="mesh", **kw)
        inst = repro_torch.solve(tp, backend="mesh", metrics=True, **kw)
    _same(bare, inst)
    assert inst.extras["collective_floats_per_chip"] > 0
    rj = repro.solve(jp, method="proxgd", rounds=5, lam=0.05, metrics=True)
    _close_metrics(inst.extras["metrics"], rj.extras["metrics"])


@pytest.mark.parametrize("method", sorted(METHODS))
def test_per_round_arrays_match_the_reference(probs, method):
    jp, tp = probs
    kw = dict(METHODS[method], rounds=4)
    rj = repro.solve(jp, method=method, metrics=True, **kw)
    rt = repro_torch.solve(tp, method=method, metrics=True, device="cpu",
                           **kw)
    mt = rt.extras["metrics"]
    for f in FIELDS:
        assert mt[f].shape == (4,) and np.all(np.isfinite(mt[f])), f
    assert mt["charged_floats_per_round"] > 0
    assert np.all(mt["step_norm"] >= 0)
    _close_metrics(mt, rj.extras["metrics"])
    _same(rt, repro_torch.solve(tp, method=method, device="cpu", **kw))


def test_shrink_fields_with_the_lazy_engine():
    """The nuclear-norm objective term and the lazy engine's cumulative
    fallback counter, equal to its host-side count and to the
    reference's."""
    jp, tp = _pair(BIG, 1)
    kw = dict(method="proxgd", rounds=6, lam=0.05, sv_engine="lazy")
    rt = repro_torch.solve(tp, metrics=True, device="cpu", **kw)
    rj = repro.solve(jp, metrics=True, **kw)
    mt = rt.extras["metrics"]
    assert np.all(mt["objective"] > 0)
    assert np.all(np.diff(mt["sv_exact"]) >= 0)
    assert int(mt["sv_exact"][-1]) == rt.extras["sv_exact_rounds"] >= 1
    _close_metrics(mt, rj.extras["metrics"])


@pytest.mark.parametrize("engine", ["exact", "lazy"])
def test_objective_matches_a_recomputation(engine):
    """objective = lam * ||W_k||_* of the recorded iterates."""
    _, tp = _pair(BIG, 1)
    lam = 0.05
    res = repro_torch.solve(tp, method="proxgd", rounds=4, lam=lam,
                            record_every=1, metrics=True, sv_engine=engine,
                            device="cpu")
    mtr = res.extras["metrics"]
    assert res.rounds_axis == [0, 1, 2, 3, 4]
    for k, W in zip(res.rounds_axis[1:], res.iterates[1:]):
        want = lam * float(torch.linalg.svdvals(W.double()).sum())
        assert abs(float(mtr["objective"][k - 1]) - want) <= 1e-5 * want


def test_metrics_with_a_checkpointed_and_a_resumed_solve(probs, tmp_path):
    _, tp = probs
    kw = dict(method="proxgd", rounds=5, lam=0.05, metrics=True,
              device="cpu")
    plain = repro_torch.solve(tp, **kw)
    d = str(tmp_path / "store")
    seg = repro_torch.solve(tp, checkpoint_every=2, ckpt_dir=d, **kw)
    os.remove(os.path.join(d, "step_00000005.npz"))
    with pytest.warns(UserWarning, match="rolling back"):
        res = repro_torch.resume(d, device="cpu")
    for other in (seg, res):
        _same(plain, other)
        for f in FIELDS:
            np.testing.assert_array_equal(plain.extras["metrics"][f],
                                          other.extras["metrics"][f])
    assert res.extras["checkpoint"]["resumed_from"] == 4


def test_metrics_stay_on_the_device_until_finalize(probs):
    """The sink holds the per-round entries as tensors (on the solve's
    device); finalize stacks them and reads each field back once."""
    _, tp = probs
    from repro_torch.runtime.base import make_runtime
    rt = make_runtime("sim", tp)
    from repro_torch.core.methods.base import metrics_channel
    entry, spec, sink = metrics_channel(True, tp)
    assert isinstance(sink, RoundMetricsSink) and spec.key == "obs"
    assert all(isinstance(v, torch.Tensor) and v.device == tp.device
               for v in entry.values())
    state = {"W": torch.zeros(tp.p, tp.m), "obs": entry}

    def body(k, st, data):
        from repro_torch.obs.device import obs_round
        W = st["W"] + 1.0
        return {"W": rt.broadcast(W, "w"), "obs": obs_round(st["W"], W)}

    rt.run_rounds(3, body, state, record=spec)
    assert all(isinstance(v["step_norm"], torch.Tensor)
               for v in sink._values)
    out = sink.finalize(rt)
    np.testing.assert_allclose(out["step_norm"],
                               np.full(3, np.sqrt(tp.p * tp.m)), rtol=1e-6)
    assert out["charged_floats_per_round"] == tp.p
    assert metrics_channel(False, tp) is None


# ---------------------------------------------------------------------------
# read_events_jsonl and the obs CLI
# ---------------------------------------------------------------------------
def test_read_events_jsonl_roundtrips_both_ways(tmp_path):
    for tracer, name in ((Tracer(), "port"), (JTracer(), "ref")):
        tracer.configure(str(tmp_path / name))
        with tracer.span("unit.work", step=3):
            pass
        tracer.emit("unit.marker", kind="x")
    port_path = tmp_path / "port" / "OBS_events.jsonl"
    ref_path = tmp_path / "ref" / "OBS_events.jsonl"
    for path in (port_path, ref_path):
        for reader in (read_events_jsonl, j_read_events):
            events = reader(str(path))
            assert [e["name"] for e in events] == ["unit.work", "unit.marker"]
            span, inst = events
            assert span["ph"] == "X" and span["dur_s"] >= 0
            assert span["attrs"] == {"step": 3}
            assert inst["ph"] == "i" and inst["dur_s"] is None
            for e in events:
                assert set(e) == {"name", "ph", "t_wall_s", "dur_s", "pid",
                                  "tid", "attrs"}


def test_obs_cli_smoke_and_summarize(tmp_path):
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src_torch"),
               OMP_NUM_THREADS="1")
    out = tmp_path / "run"
    smoke = subprocess.run(
        [sys.executable, "-m", "repro_torch.obs", "smoke", "--out", str(out),
         "--device", "cpu"], env=env, capture_output=True, text=True,
        timeout=120)
    assert smoke.returncode == 0, smoke.stdout + smoke.stderr
    assert "smoke: ok" in smoke.stdout
    for name in ("OBS_events.jsonl", "OBS_trace.json", "OBS_metrics.json",
                 "OBS_metrics.prom"):
        assert (out / name).exists(), name
    trace = json.loads((out / "OBS_trace.json").read_text())
    assert {e["name"] for e in trace["traceEvents"]} >= {
        "solve", "streaming.refresh"}
    summary = subprocess.run(
        [sys.executable, "-m", "repro_torch.obs", "summarize", str(out)],
        env=env, capture_output=True, text=True, timeout=120)
    assert summary.returncode == 0, summary.stderr
    for want in ("span  solve", "streaming_staleness_oldest_seconds",
                 "serve_latency_seconds"):
        assert want in summary.stdout, want
