"""SLO metrics: counters, gauges, and fixed-log-bucket latency histograms.

The port's own copy of ``repro.obs.metrics`` (pure Python and numpy),
with :func:`device_bucket_counts` in torch.  Design constraints, as in
the reference:

* **Fixed log buckets.**  Bucket edges are a geometric ladder computed
  once at construction, so ``observe`` is a ``searchsorted`` into a
  static array.  :func:`device_bucket_counts` buckets a batch of
  durations on the device with the same edges, so host histogram and
  device counts agree bucket for bucket.
* **Percentiles by log interpolation** inside the containing bucket,
  clamped to the observed min/max.
* **One registry** hands out named instruments (get-or-create) and
  snapshots them as JSON or Prometheus text.

Instruments are plain host objects, updated around device work and
never inside it.
"""
from __future__ import annotations

import json
import math
import os
import threading
import time
from typing import Dict, List, Optional

import numpy as np
import torch

__all__ = [
    "Counter", "Gauge", "LatencyHistogram", "MetricsRegistry",
    "bucket_edges", "device_bucket_counts", "default_registry",
]

# Default latency ladder: 1 microsecond .. 100 s across 64 buckets,
# plus an underflow and an overflow bucket at the ends.
DEFAULT_LO = 1e-6
DEFAULT_HI = 1e2
DEFAULT_BUCKETS = 64


def bucket_edges(lo: float = DEFAULT_LO, hi: float = DEFAULT_HI,
                 n: int = DEFAULT_BUCKETS) -> np.ndarray:
    """The geometric bucket ladder: n+1 edges from lo to hi."""
    if not (0 < lo < hi) or n < 1:
        raise ValueError(f"need 0 < lo < hi and n >= 1, got "
                         f"lo={lo}, hi={hi}, n={n}")
    return np.geomspace(lo, hi, n + 1)


def device_bucket_counts(seconds, edges) -> torch.Tensor:
    """Bucket a batch of durations where they lie (host or card).

    ``seconds``: a tensor of non-negative durations; ``edges``: the
    (n+1,) ladder from :func:`bucket_edges`.  Returns (n+2,) int32
    counts — [underflow, bucket 0..n-1, overflow] — identical to what
    ``LatencyHistogram.observe`` accumulates one value at a time; fold
    them into a host histogram with :meth:`LatencyHistogram.merge_counts`.
    """
    seconds = torch.as_tensor(seconds)
    edges = torch.as_tensor(edges, dtype=seconds.dtype, device=seconds.device)
    idx = torch.searchsorted(edges, seconds.reshape(-1).contiguous(), right=True)
    return torch.bincount(idx, minlength=edges.shape[0] + 1).to(torch.int32)


class Counter:
    """A monotonically increasing count (requests, waves, evictions)."""

    def __init__(self, name: str):
        self.name = name
        self._value = 0
        self._lock = threading.Lock()

    def inc(self, n: int = 1) -> None:
        with self._lock:
            self._value += n

    @property
    def value(self) -> int:
        return self._value

    def snapshot(self) -> Dict[str, object]:
        return {"type": "counter", "value": self._value}


class Gauge:
    """A point-in-time value (staleness seconds, buffer fill)."""

    def __init__(self, name: str):
        self.name = name
        self._value: Optional[float] = None
        self._t_set: Optional[float] = None

    def set(self, value: float) -> None:
        self._value = float(value)
        self._t_set = time.time()

    @property
    def value(self) -> Optional[float]:
        return self._value

    def snapshot(self) -> Dict[str, object]:
        return {"type": "gauge", "value": self._value,
                "t_set_wall_s": self._t_set}


class LatencyHistogram:
    """Fixed-log-bucket duration histogram with quantile estimates.

    Counts land in ``n + 2`` slots: an underflow bucket ``[0, lo)``,
    the ``n`` geometric buckets, and an overflow bucket ``[hi, inf)``.
    Observed min/max are tracked exactly so quantile estimates never
    leave the observed range.
    """

    def __init__(self, name: str, lo: float = DEFAULT_LO,
                 hi: float = DEFAULT_HI, n: int = DEFAULT_BUCKETS):
        self.name = name
        self.edges = bucket_edges(lo, hi, n)
        self.counts = np.zeros(n + 2, np.int64)
        self.sum = 0.0
        self.min: Optional[float] = None
        self.max: Optional[float] = None
        self._lock = threading.Lock()

    @property
    def count(self) -> int:
        return int(self.counts.sum())

    def observe(self, seconds: float) -> None:
        s = float(seconds)
        idx = int(np.searchsorted(self.edges, s, side="right"))
        with self._lock:
            self.counts[idx] += 1
            self.sum += s
            self.min = s if self.min is None else min(self.min, s)
            self.max = s if self.max is None else max(self.max, s)

    def merge_counts(self, counts, *, total_seconds: float = 0.0) -> None:
        """Fold in (n+2,) bucket counts (e.g. from
        :func:`device_bucket_counts`); min/max stay histogram-grained."""
        if isinstance(counts, torch.Tensor):
            counts = counts.cpu().numpy()
        counts = np.asarray(counts, np.int64)
        if counts.shape != self.counts.shape:
            raise ValueError(f"expected {self.counts.shape} counts, got "
                             f"{counts.shape}")
        with self._lock:
            self.counts += counts
            self.sum += float(total_seconds)

    def percentile(self, q: float) -> Optional[float]:
        """Estimate the q-quantile (q in [0, 1]) by geometric
        interpolation inside the containing bucket."""
        total = self.count
        if total == 0:
            return None
        rank = q * (total - 1) + 1            # 1-based rank of the quantile
        cum = np.cumsum(self.counts)
        idx = int(np.searchsorted(cum, rank, side="left"))
        lo_edge, hi_edge = self._bucket_bounds(idx)
        prev = cum[idx - 1] if idx > 0 else 0
        in_bucket = self.counts[idx]
        frac = (rank - prev) / in_bucket if in_bucket else 0.0
        frac = min(max(frac, 0.0), 1.0)
        if lo_edge > 0 and math.isfinite(hi_edge):
            est = lo_edge * (hi_edge / lo_edge) ** frac
        else:                                  # under/overflow buckets
            est = hi_edge if math.isfinite(hi_edge) else lo_edge
        if self.min is not None:
            est = min(max(est, self.min), self.max)
        return float(est)

    def _bucket_bounds(self, idx: int):
        if idx == 0:
            return 0.0, float(self.edges[0])
        if idx >= len(self.edges):
            return float(self.edges[-1]), math.inf
        return float(self.edges[idx - 1]), float(self.edges[idx])

    def snapshot(self) -> Dict[str, object]:
        return {
            "type": "histogram",
            "count": self.count,
            "sum_s": self.sum,
            "min_s": self.min,
            "max_s": self.max,
            "p50_s": self.percentile(0.50),
            "p90_s": self.percentile(0.90),
            "p99_s": self.percentile(0.99),
            "edges_s": [float(e) for e in self.edges],
            "counts": [int(c) for c in self.counts],
        }


class MetricsRegistry:
    """Named instruments with get-or-create semantics + exporters."""

    def __init__(self):
        self._instruments: Dict[str, object] = {}
        self._lock = threading.Lock()

    def _get(self, name: str, cls, *args, **kwargs):
        with self._lock:
            inst = self._instruments.get(name)
            if inst is None:
                inst = cls(name, *args, **kwargs)
                self._instruments[name] = inst
            elif not isinstance(inst, cls):
                raise TypeError(
                    f"metric {name!r} already registered as "
                    f"{type(inst).__name__}, requested {cls.__name__}")
            return inst

    def counter(self, name: str) -> Counter:
        return self._get(name, Counter)

    def gauge(self, name: str) -> Gauge:
        return self._get(name, Gauge)

    def histogram(self, name: str, lo: float = DEFAULT_LO,
                  hi: float = DEFAULT_HI,
                  n: int = DEFAULT_BUCKETS) -> LatencyHistogram:
        return self._get(name, LatencyHistogram, lo, hi, n)

    def names(self) -> List[str]:
        return sorted(self._instruments)

    def snapshot(self) -> Dict[str, object]:
        """JSON-able state of every instrument."""
        return {"t_wall_s": time.time(),
                "metrics": {n: self._instruments[n].snapshot()
                            for n in self.names()}}

    def write_snapshot(self, path: str) -> None:
        d = os.path.dirname(path)
        if d:
            os.makedirs(d, exist_ok=True)
        tmp = path + ".tmp"
        with open(tmp, "w") as f:
            json.dump(self.snapshot(), f, indent=2, sort_keys=True)
        os.replace(tmp, path)

    def to_prometheus(self) -> str:
        """Prometheus text exposition format (seconds units kept)."""
        lines: List[str] = []
        for name in self.names():
            inst = self._instruments[name]
            if isinstance(inst, Counter):
                lines.append(f"# TYPE {name} counter")
                lines.append(f"{name} {inst.value}")
            elif isinstance(inst, Gauge):
                lines.append(f"# TYPE {name} gauge")
                v = inst.value
                lines.append(f"{name} {'NaN' if v is None else v}")
            elif isinstance(inst, LatencyHistogram):
                lines.append(f"# TYPE {name} histogram")
                cum = 0
                for i, c in enumerate(inst.counts):
                    cum += int(c)
                    le = (math.inf if i >= len(inst.edges)
                          else float(inst.edges[i]))
                    le_s = "+Inf" if math.isinf(le) else repr(le)
                    lines.append(f'{name}_bucket{{le="{le_s}"}} {cum}')
                lines.append(f"{name}_sum {inst.sum}")
                lines.append(f"{name}_count {inst.count}")
        return "\n".join(lines) + "\n"


_DEFAULT = MetricsRegistry()


def default_registry() -> MetricsRegistry:
    """The process-wide registry — what ``MTLServer`` reports into
    unless handed an explicit one."""
    return _DEFAULT
