"""The port's copies of ``repro.obs`` and ``repro.train.checkpoint``
against the reference on the same observations and states, on the CPU.
Everything here is compared exactly."""
import json
import pathlib
import sys
import warnings

import numpy as np
import pytest

torch = pytest.importorskip("torch")
sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1] / "src_torch"))

from repro.obs import metrics as jmet  # noqa: E402
from repro.obs import tracing as jtr  # noqa: E402
from repro.train import checkpoint as jck  # noqa: E402
from repro_torch.obs import metrics as tmet  # noqa: E402
from repro_torch.obs import tracing as ttr  # noqa: E402
from repro_torch.train import checkpoint as tck  # noqa: E402


def _latencies(n=500, seed=0):
    rng = np.random.default_rng(seed)
    lat = rng.lognormal(np.log(2e-3), 1.0, n)
    return np.concatenate([lat, [1e-7, 0.0, 250.0]])      # under/overflow


@pytest.mark.parametrize("seed", [0, 1])
def test_histogram_matches_reference(seed):
    jh, th = jmet.LatencyHistogram("lat"), tmet.LatencyHistogram("lat")
    for v in _latencies(seed=seed):
        jh.observe(v)
        th.observe(v)
    assert th.snapshot() == jh.snapshot()
    for q in (0.0, 0.1, 0.5, 0.9, 0.99, 1.0):
        assert th.percentile(q) == jh.percentile(q)


def test_device_bucket_counts_match_reference():
    lat = _latencies(seed=2)
    edges = tmet.bucket_edges()
    got = tmet.device_bucket_counts(torch.from_numpy(lat), edges)
    want = np.asarray(jmet.device_bucket_counts(lat.astype(np.float32), edges))
    np.testing.assert_array_equal(got.numpy(), want)
    th = tmet.LatencyHistogram("lat")
    th.merge_counts(got)
    assert th.count == len(lat)


def test_registry_exports_match_reference():
    regs = (jmet.MetricsRegistry(), tmet.MetricsRegistry())
    for reg in regs:
        reg.counter("serve_requests_total").inc(1024)
        reg.counter("serve_waves_total").inc(4)
        reg.gauge("staleness_seconds").set(0.25)
        hist = reg.histogram("serve_latency_seconds")
        for v in _latencies(50, seed=3):
            hist.observe(v)
    assert regs[1].to_prometheus() == regs[0].to_prometheus()
    snaps = [r.snapshot()["metrics"] for r in regs]
    for snap in snaps:
        snap["staleness_seconds"].pop("t_set_wall_s")
    assert snaps[1] == snaps[0]
    with pytest.raises(TypeError):
        regs[1].gauge("serve_requests_total")


def _drive(tracer):
    tracer.emit("serve.swap_evicted", version="abc", n=np.int64(3))
    with tracer.span("serve.swap", version="v1", step=2) as extra:
        extra["swapped"] = True
    with pytest.raises(KeyError):
        with tracer.span("serve.maybe_reload", store="s"):
            raise KeyError("x")
    for k in range(6):                                    # past the ring
        tracer.emit("tick", k=k, shape=(2, 3))


def test_tracer_ring_matches_reference(tmp_path):
    jt = jtr.Tracer(capacity=5)
    tt = ttr.Tracer(capacity=5)
    tt.configure(str(tmp_path))
    _drive(jt)
    _drive(tt)

    def strip(ev):
        return {k: v for k, v in ev.items() if k not in ("t_wall_s", "dur_s")}

    assert [strip(e) for e in tt.events()] == [strip(e) for e in jt.events()]
    assert len(tt.events()) == 5
    # the JSONL stream holds every event, in the reference's schema
    streamed = jtr.read_events_jsonl(tt.jsonl_path)
    assert len(streamed) == 9
    assert streamed[2]["attrs"]["error"] == "KeyError"
    assert streamed[1]["ph"] == "X" and streamed[1]["dur_s"] >= 0.0
    # Chrome trace export writes the same file for the same events
    ja = json.loads(pathlib.Path(jtr.export_chrome_trace(
        streamed, str(tmp_path / "j.json"))).read_text())
    ta = json.loads(pathlib.Path(ttr.export_chrome_trace(
        streamed, str(tmp_path / "t.json"))).read_text())
    assert ta == ja


def test_profiler_session_writes_a_torch_trace(tmp_path):
    with ttr.profiler_session(str(tmp_path)):
        torch.ones(64).cumsum(0)
    trace = json.loads((tmp_path / ttr.TORCH_TRACE_JSON).read_text())
    assert trace["traceEvents"]


def _state(seed=0):
    rng = np.random.default_rng(seed)
    return {"U": rng.standard_normal((6, 2)).astype(np.float32),
            "opt": [rng.standard_normal(3).astype(np.float32),
                    np.arange(4, dtype=np.int32)],
            "nested": {"b": np.frombuffer(b"{}", np.uint8).copy(),
                       "a": np.float32(1.5)}}


def test_content_hash_matches_reference():
    flat = jck._flatten(_state())
    assert list(tck._flatten(_state())) == list(flat)
    assert tck.content_hash(flat) == jck.content_hash(flat)
    as_tensors = {k: torch.from_numpy(np.array(v)) for k, v in flat.items()}
    assert tck.content_hash(as_tensors) == jck.content_hash(flat)


def test_checkpoints_cross_load_both_ways(tmp_path):
    d = str(tmp_path / "ck")
    jck.save_checkpoint(d, 3, _state(0))
    step, tree = tck.load_checkpoint(d)
    assert step == 3 and isinstance(tree["opt"], list)
    np.testing.assert_array_equal(tree["U"].numpy(), _state(0)["U"])
    np.testing.assert_array_equal(tree["opt"][1].numpy(), np.arange(4))
    tck.save_checkpoint(d, 4, {k: v for k, v in tree.items()}, keep=1)
    assert tck.available_steps(d) == jck.available_steps(d) == [4]
    step, back = jck.load_checkpoint(d)
    assert step == 4
    np.testing.assert_array_equal(np.asarray(back["nested"]["b"]),
                                  _state(0)["nested"]["b"])


def test_corrupt_step_raises_and_latest_skips_it(tmp_path):
    d = str(tmp_path / "ck")
    for step in (0, 1):
        tck.save_checkpoint(d, step, _state(step), keep=None)
    path = pathlib.Path(d) / "step_00000001.npz"
    raw = bytearray(path.read_bytes())
    at = bytes(raw).find(_state(1)["U"].tobytes())
    assert at > 0
    raw[at + 5] ^= 0xFF                          # flip one byte of U
    path.write_bytes(bytes(raw))
    with pytest.raises(tck.CheckpointCorruptError) as e:
        tck.load_checkpoint(d, 1)
    assert e.value.step == 1
    with pytest.raises(jck.CheckpointCorruptError):
        jck.load_checkpoint(d, 1)
    with warnings.catch_warnings(record=True):
        warnings.simplefilter("always")
        step, tree = tck.load_checkpoint(d)
    assert step == 0
    np.testing.assert_array_equal(tree["U"].numpy(), _state(0)["U"])
    with pytest.raises(ValueError):
        tck.save_checkpoint(d, 2, _state(), keep=0)
