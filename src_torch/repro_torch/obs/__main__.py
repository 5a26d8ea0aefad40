"""CLI for the telemetry layer: ``python -m repro_torch.obs <cmd>``.

Port of ``repro.obs.__main__``.

* ``summarize RUN_DIR`` — render a run directory's telemetry: span
  totals from ``OBS_events.jsonl`` and the latency/staleness numbers
  from ``OBS_metrics.json`` (written by :meth:`MetricsRegistry
  .write_snapshot`).
* ``smoke --out RUN_DIR [--device cpu]`` — the instrumented tiny solve,
  serve and streaming path: a metrics-on solve (its W and ledger held
  bitwise to a metrics-off twin), a scored and onboarded server, a
  streaming refresh published to it, then ``OBS_events.jsonl``,
  ``OBS_trace.json`` (Chrome/Perfetto) and ``OBS_metrics.json`` in the
  run directory.  Exit code 0 iff every artifact landed and the
  bit-identity held.  It runs on the card unless ``--device cpu``.
"""
from __future__ import annotations

import json
import os
import sys
from typing import List, Optional


def _fmt_s(v: Optional[float]) -> str:
    if v is None:
        return "-"
    if v < 1e-3:
        return f"{v * 1e6:.1f}us"
    if v < 1.0:
        return f"{v * 1e3:.2f}ms"
    return f"{v:.3f}s"


def summarize(run_dir: str) -> str:
    """Human-readable rollup of a run directory's telemetry files."""
    from .tracing import EVENTS_JSONL, read_events_jsonl
    lines: List[str] = [f"obs summary: {run_dir}"]

    ev_path = os.path.join(run_dir, EVENTS_JSONL)
    if os.path.exists(ev_path):
        events = read_events_jsonl(ev_path)
        spans: dict = {}
        instants: dict = {}
        for ev in events:
            if ev.get("ph") == "X":
                tot, n = spans.get(ev["name"], (0.0, 0))
                spans[ev["name"]] = (tot + (ev.get("dur_s") or 0.0), n + 1)
            else:
                instants[ev["name"]] = instants.get(ev["name"], 0) + 1
        lines.append(f"  events: {len(events)} ({ev_path})")
        for name in sorted(spans, key=lambda n: -spans[n][0]):
            tot, n = spans[name]
            lines.append(f"    span  {name:<28} x{n:<4} "
                         f"total {_fmt_s(tot)}")
        for name in sorted(instants):
            lines.append(f"    event {name:<28} x{instants[name]}")
    else:
        lines.append(f"  no {EVENTS_JSONL}")

    met_path = os.path.join(run_dir, "OBS_metrics.json")
    if os.path.exists(met_path):
        with open(met_path) as f:
            snap = json.load(f)
        lines.append(f"  metrics: {len(snap.get('metrics', {}))} "
                     f"({met_path})")
        for name, m in sorted(snap.get("metrics", {}).items()):
            if m["type"] == "histogram":
                lines.append(
                    f"    hist  {name:<34} n={m['count']:<6} "
                    f"p50 {_fmt_s(m['p50_s'])} p99 {_fmt_s(m['p99_s'])}")
            elif m["type"] == "counter":
                lines.append(f"    count {name:<34} {m['value']}")
            else:
                lines.append(f"    gauge {name:<34} {m['value']}")
    else:
        lines.append("  no OBS_metrics.json")
    return "\n".join(lines)


def smoke(out_dir: str, device=None) -> int:
    """The instrumented tiny solve + serve + streaming path."""
    import numpy as np
    import torch

    from .. import api
    from ..core.methods.base import MTLProblem
    from .metrics import default_registry
    from .tracing import TRACE_JSON, configure, default_tracer

    os.makedirs(out_dir, exist_ok=True)
    configure(out_dir)

    # -- device round metrics: instrumented vs bare must be bit-identical
    rng = np.random.default_rng(0)
    m, n, p = 4, 24, 8
    Xs = rng.normal(size=(m, n, p))
    W0 = rng.normal(size=(p, m))
    ys = np.einsum("mnp,pm->mn", Xs, W0) + 0.01 * rng.normal(size=(m, n))
    prob = MTLProblem.make(Xs, ys, device=device)
    bare = api.solve(prob, method="proxgd", rounds=8, lam=0.05,
                     device=prob.device)
    inst = api.solve(prob, method="proxgd", rounds=8, lam=0.05,
                     metrics=True, device=prob.device)
    mtr = inst.extras["metrics"]
    ok = bool(torch.equal(bare.W, inst.W)
              and bare.comm.events == inst.comm.events
              and mtr["round"].shape == (8,))

    # -- serving SLOs: score waves, onboard a task
    server = None
    try:
        from ..serve.mtl import MTLServer
        server = MTLServer(inst.factorize(rank=3), batch_size=16)
        ids = rng.integers(0, m, size=50).astype(np.int32)
        Xq = rng.normal(size=(50, p)).astype(np.float32)
        for _ in range(5):
            server.score(ids, Xq)
        server.onboard(None, rng.normal(size=(6, p)).astype(np.float32),
                       rng.normal(size=(6,)).astype(np.float32))
    except Exception as e:                     # pragma: no cover
        print(f"smoke: serve leg failed: {type(e).__name__}: {e}")
        ok = False

    # -- streaming staleness through the same registry
    try:
        from ..train.streaming import SampleStream, StreamingResolver
        store = os.path.join(out_dir, "stream_store")
        stream = SampleStream(W0, np.eye(p), seed=0, device=prob.device)
        resolver = StreamingResolver(prob, server, store, method="proxgd",
                                     rounds=3, solver_hp={"lam": 0.05})
        resolver.step(stream, 4)
    except Exception as e:                     # pragma: no cover
        print(f"smoke: streaming leg failed: {type(e).__name__}: {e}")
        ok = False

    reg = default_registry()
    reg.write_snapshot(os.path.join(out_dir, "OBS_metrics.json"))
    with open(os.path.join(out_dir, "OBS_metrics.prom"), "w") as f:
        f.write(reg.to_prometheus())
    default_tracer().export_chrome_trace(os.path.join(out_dir, TRACE_JSON))

    print(summarize(out_dir))
    lat = reg.histogram("serve_latency_seconds")
    ok = ok and lat.count > 0 \
        and os.path.exists(os.path.join(out_dir, TRACE_JSON))
    print(f"smoke: {'ok' if ok else 'FAILED'} "
          f"(serve n={lat.count}, p50={_fmt_s(lat.percentile(0.5))}, "
          f"p99={_fmt_s(lat.percentile(0.99))})")
    return 0 if ok else 1


def main(argv: Optional[List[str]] = None) -> None:
    import argparse
    ap = argparse.ArgumentParser(prog="repro_torch.obs")
    sub = ap.add_subparsers(dest="cmd", required=True)

    s = sub.add_parser("summarize", help="render a run directory's "
                                         "telemetry files")
    s.add_argument("run_dir")

    k = sub.add_parser("smoke", help="instrumented tiny solve + serve + "
                                     "streaming refresh")
    k.add_argument("--out", default="OBS_run")
    k.add_argument("--device", default=None,
                   help="where to run (default: the card)")

    args = ap.parse_args(argv)
    if args.cmd == "summarize":
        print(summarize(args.run_dir))
    else:
        sys.exit(smoke(args.out, device=args.device))


if __name__ == "__main__":
    main()
