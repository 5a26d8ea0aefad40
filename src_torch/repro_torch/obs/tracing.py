"""Host span tracing: where a serve run spends its wall clock.

The port's own copy of ``repro.obs.tracing``.  A :class:`Tracer` keeps
a bounded in-memory ring of events and, optionally, streams them to a
JSONL file under a configured run directory.  Spans record one COMPLETE
event at exit (wall start + ``perf_counter`` duration); instants are
zero-duration markers.  The JSONL schema is the reference's::

    {"name": str, "ph": "X" | "i", "t_wall_s": float,
     "dur_s": float | null, "pid": int, "tid": int, "attrs": {...}}

``profiler_session`` hands the run directory to ``torch.profiler`` (in
place of the reference's ``jax.profiler``) for a device timeline beside
the host spans.  Spans are host-side only: they time around device
work, which stays asynchronous inside them.
"""
from __future__ import annotations

import contextlib
import json
import os
import threading
import time
from collections import deque
from typing import Any, Dict, Iterator, List, Optional

__all__ = [
    "Tracer", "trace_span", "emit_event", "default_tracer", "configure",
    "export_chrome_trace", "profiler_session", "EVENTS_JSONL",
    "TORCH_TRACE_JSON",
]

EVENTS_JSONL = "OBS_events.jsonl"
TORCH_TRACE_JSON = "OBS_torch_trace.json"

# environment hook: set REPRO_OBS_DIR to stream the default tracer's
# events without touching call sites (the reference reads the same name)
_ENV_DIR = "REPRO_OBS_DIR"


class Tracer:
    """Bounded event ring + optional JSONL stream."""

    def __init__(self, capacity: int = 4096):
        self.capacity = int(capacity)
        self._ring: deque = deque(maxlen=self.capacity)
        self._lock = threading.Lock()
        self._jsonl_path: Optional[str] = None
        env_dir = os.environ.get(_ENV_DIR)
        if env_dir:
            self.configure(env_dir)

    def configure(self, run_dir: Optional[str]) -> Optional[str]:
        """Stream subsequent events to ``run_dir/OBS_events.jsonl``
        (append mode).  ``None`` turns streaming off.  Returns the path."""
        with self._lock:
            if run_dir is None:
                self._jsonl_path = None
                return None
            os.makedirs(run_dir, exist_ok=True)
            self._jsonl_path = os.path.join(run_dir, EVENTS_JSONL)
            return self._jsonl_path

    @property
    def jsonl_path(self) -> Optional[str]:
        return self._jsonl_path

    @staticmethod
    def _jsonable(v: Any) -> Any:
        if isinstance(v, (str, int, float, bool)) or v is None:
            return v
        if isinstance(v, (list, tuple)):
            return [Tracer._jsonable(x) for x in v]
        if isinstance(v, dict):
            return {str(k): Tracer._jsonable(x) for k, x in v.items()}
        try:                                   # numpy / torch scalars
            return v.item()
        except (AttributeError, ValueError, RuntimeError):
            return repr(v)

    def emit(self, name: str, *, ph: str = "i",
             t_wall_s: Optional[float] = None,
             dur_s: Optional[float] = None, **attrs) -> Dict[str, Any]:
        ev = {
            "name": str(name),
            "ph": ph,
            "t_wall_s": time.time() if t_wall_s is None else t_wall_s,
            "dur_s": dur_s,
            "pid": os.getpid(),
            "tid": threading.get_ident() & 0xFFFF,
            "attrs": {k: self._jsonable(v) for k, v in attrs.items()},
        }
        with self._lock:
            self._ring.append(ev)
            path = self._jsonl_path
        if path is not None:
            line = json.dumps(ev, sort_keys=True)
            with self._lock:
                with open(path, "a") as f:
                    f.write(line + "\n")
        return ev

    @contextlib.contextmanager
    def span(self, name: str, **attrs) -> Iterator[Dict[str, Any]]:
        """Time a block; the event records even when the block raises
        (with ``attrs["error"]`` set to the exception type)."""
        t_wall = time.time()
        t0 = time.perf_counter()
        extra: Dict[str, Any] = {}
        try:
            yield extra
        except BaseException as e:
            extra["error"] = type(e).__name__
            raise
        finally:
            dur = time.perf_counter() - t0
            self.emit(name, ph="X", t_wall_s=t_wall, dur_s=dur,
                      **{**attrs, **extra})

    def events(self) -> List[Dict[str, Any]]:
        with self._lock:
            return list(self._ring)

    def clear(self) -> None:
        with self._lock:
            self._ring.clear()

    def export_chrome_trace(self, path: str) -> str:
        return export_chrome_trace(self.events(), path)


def export_chrome_trace(events: List[Dict[str, Any]], path: str) -> str:
    """Write events as Chrome ``trace.json``:
    ``{"traceEvents": [...]}`` with microsecond timestamps."""
    out = []
    for ev in events:
        ch = {
            "name": ev["name"],
            "ph": "X" if ev.get("ph") == "X" else "i",
            "ts": ev["t_wall_s"] * 1e6,
            "pid": ev.get("pid", 0),
            "tid": ev.get("tid", 0),
            "args": ev.get("attrs", {}),
        }
        if ch["ph"] == "X":
            ch["dur"] = (ev.get("dur_s") or 0.0) * 1e6
        else:
            ch["s"] = "p"                      # process-scoped instant
        out.append(ch)
    d = os.path.dirname(path)
    if d:
        os.makedirs(d, exist_ok=True)
    tmp = path + ".tmp"
    with open(tmp, "w") as f:
        json.dump({"traceEvents": out, "displayTimeUnit": "ms"}, f)
    os.replace(tmp, path)
    return path


@contextlib.contextmanager
def profiler_session(log_dir: str):
    """``torch.profiler`` hand-off: host and (when a card is present)
    device activity of the block, written as a Chrome trace to
    ``log_dir/OBS_torch_trace.json`` beside the host spans."""
    import torch
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with torch.profiler.profile(activities=acts) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(log_dir, TORCH_TRACE_JSON))


_DEFAULT = Tracer()


def default_tracer() -> Tracer:
    return _DEFAULT


def configure(run_dir: Optional[str]) -> Optional[str]:
    """Point the default tracer's JSONL stream at ``run_dir``."""
    return _DEFAULT.configure(run_dir)


def trace_span(name: str, **attrs):
    """``with trace_span("serve.swap", version=v): ...`` on the default
    tracer."""
    return _DEFAULT.span(name, **attrs)


def emit_event(name: str, **attrs) -> Dict[str, Any]:
    """Record an instant event on the default tracer."""
    return _DEFAULT.emit(name, **attrs)
