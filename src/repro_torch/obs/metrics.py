"""In-process metrics registry for the dispatch path (jax-free).

Counters and histograms the tracer (and anything else on the routing path)
accumulates into; `MetricsRegistry.to_dict()` is the snapshot the run
report embeds. Deliberately tiny and deterministic:

- counters are plain ints, or 0-d device tensors where a count is taken
  on the device without a host read (`moe.dropped`), read as ints when
  the snapshot is taken;
- histograms keep running count/sum/min/max plus the FIRST `max_samples`
  observations (a deterministic cap, not a random reservoir — two runs of
  the same program produce identical snapshots), from which the snapshot
  derives percentiles (p50/p95/p99 — p99 is what the serving harness's SLO
  accounting hangs its tail-latency bounds on). Observations past the cap
  still update the running stats, so count/mean/min/max stay exact.

Everything is wall-clock-agnostic: callers pass the values; the registry
never reads a clock itself.
"""
from __future__ import annotations

from typing import Dict, List


class Counter:
    __slots__ = ("value",)

    def __init__(self) -> None:
        self.value = 0

    def inc(self, n=1) -> None:
        """Add `n`, an int or a 0-d tensor (summed out of place, so the
        caller's tensor is never written)."""
        self.value = self.value + n

    def to_dict(self) -> int:
        return int(self.value)


class Histogram:
    """Running stats + a deterministic first-N sample cap for percentiles."""

    __slots__ = ("count", "total", "min", "max", "samples", "max_samples")

    def __init__(self, max_samples: int = 4096) -> None:
        self.count = 0
        self.total = 0.0
        self.min = float("inf")
        self.max = float("-inf")
        self.samples: List[float] = []
        self.max_samples = max_samples

    def observe(self, value: float) -> None:
        value = float(value)
        self.count += 1
        self.total += value
        self.min = min(self.min, value)
        self.max = max(self.max, value)
        if len(self.samples) < self.max_samples:
            self.samples.append(value)

    def percentile(self, q: float) -> float:
        """Nearest-rank percentile over the retained samples (0 <= q <= 1)."""
        if not self.samples:
            return 0.0
        ordered = sorted(self.samples)
        idx = min(len(ordered) - 1, max(0, round(q * (len(ordered) - 1))))
        return ordered[idx]

    def to_dict(self) -> Dict[str, float]:
        if not self.count:
            return {"count": 0, "sum": 0.0, "mean": 0.0, "min": 0.0,
                    "max": 0.0, "p50": 0.0, "p95": 0.0, "p99": 0.0}
        return {"count": self.count, "sum": self.total,
                "mean": self.total / self.count,
                "min": self.min, "max": self.max,
                "p50": self.percentile(0.5), "p95": self.percentile(0.95),
                "p99": self.percentile(0.99)}


class MetricsRegistry:
    """Named counters + histograms with a JSON-able snapshot."""

    def __init__(self, max_samples: int = 4096) -> None:
        self._counters: Dict[str, Counter] = {}
        self._histograms: Dict[str, Histogram] = {}
        self._max_samples = max_samples

    def counter(self, name: str) -> Counter:
        c = self._counters.get(name)
        if c is None:
            c = self._counters[name] = Counter()
        return c

    def histogram(self, name: str) -> Histogram:
        h = self._histograms.get(name)
        if h is None:
            h = self._histograms[name] = Histogram(self._max_samples)
        return h

    def observe(self, name: str, value: float) -> None:
        self.histogram(name).observe(value)

    def to_dict(self) -> Dict[str, object]:
        return {
            "counters": {k: c.to_dict()
                         for k, c in sorted(self._counters.items())},
            "histograms": {k: h.to_dict()
                           for k, h in sorted(self._histograms.items())},
        }
