"""Dispatch tracer with Chrome trace-event export, and the port's one
profiler scope helper (jax-free).

Two clocks. `profile_scope` names a region for `torch.profiler`: a
`record_function` range on the profiler's own clock, so the kernels
launched inside it can be attributed to it (`dit_gemm.<mode>`,
`gemm.resolve`, `gemm.cast`, `mmad.launch`, `moe.einsums`, the SSM state
loops, `train.step`, `train.forward`, `train.loss`, `train.backward`,
`optim.adamw`, `optim.clip`). It is entered only while a profiler runs:
with none it is a `nullcontext` and costs one attribute read.

`Tracer` records what the routing path decided. One per run, installed by
a launcher via `set_tracer` the same way `shard_ctx.set_gemm_context`
installs the routing context. `pmm` and `pattn` consult `get_tracer()` on
the first call of each (tag, shape), which they resolve and memoize: with
no tracer installed that costs one global read and a None check. A `pmm`
span covers that first call (plan consult, lowering and the first
dispatch) and carries its provenance (`tag`, shape, hit/bucketed/fallback,
plan and calibration digests, resolved mode, fallback reasons, predicted
cost), which `obs.report.dispatch_provenance` lifts into the run report
(`dispatches[].dur_us` is the span's own time). Spans run on the
Tracer's `perf_counter` clock, which starts at its construction; each
also enters `profile_scope`, so under a profiler it lands on the
profiler's timeline beside its kernels.

Export is the Chrome trace-event JSON format, loadable directly at
https://ui.perfetto.dev: complete events (`ph: "X"`, microsecond `ts`/
`dur`) plus `ph: "M"` process-name metadata.
"""
from __future__ import annotations

import contextlib
import json
import os
import tempfile
import time
from typing import Any, Dict, Iterator, List, Optional

import torch

from repro_torch.obs.metrics import MetricsRegistry

# span categories used by the dispatch path ("cat" in the trace events)
CAT_PMM = "pmm"
CAT_STEP = "step"


def profiling() -> bool:
    """Whether a `torch.profiler` (or autograd profiler) is running."""
    return torch.autograd.profiler._is_profiler_enabled


def profile_scope(name: str):
    """A `record_function` range named `name` while a profiler runs, else
    a `nullcontext`: a `record_function` costs host time on every entry
    even with no profiler running."""
    if profiling():
        return torch.profiler.record_function(name)
    return contextlib.nullcontext()


class Tracer:
    """Collects trace events + the run's metrics; bounded, append-only."""

    def __init__(self, process_name: str = "repro",
                 max_events: int = 100_000) -> None:
        self.process_name = process_name
        self.max_events = max_events
        self.events: List[Dict[str, Any]] = []
        self.dropped = 0
        self.metrics = MetricsRegistry()
        self._t0_ns = time.perf_counter_ns()

    def _now_us(self) -> float:
        return (time.perf_counter_ns() - self._t0_ns) / 1e3

    def _emit(self, event: Dict[str, Any]) -> None:
        if len(self.events) >= self.max_events:
            self.dropped += 1
            return
        self.events.append(event)

    @contextlib.contextmanager
    def span(self, name: str, cat: str = CAT_PMM,
             **args: Any) -> Iterator[Dict[str, Any]]:
        """A complete ("X") trace event around the block, which is also a
        `profile_scope` of the same name.

        Yields the event's mutable `args` dict so callers can attach
        provenance discovered mid-span (resolved mode, plan digest, ...).
        """
        span_args: Dict[str, Any] = dict(args)
        with profile_scope(name):
            t0 = self._now_us()
            try:
                yield span_args
            finally:
                dur = self._now_us() - t0
                span_args["dur_us"] = round(dur, 1)
                self._emit({"name": name, "cat": cat, "ph": "X",
                            "ts": round(t0, 1), "dur": round(dur, 1),
                            "pid": 0, "tid": 0, "args": span_args})

    def instant(self, name: str, cat: str = CAT_PMM, **args: Any) -> None:
        """A zero-duration ("i") event — markers like unrouted dispatches."""
        self._emit({"name": name, "cat": cat, "ph": "i", "s": "t",
                    "ts": round(self._now_us(), 1), "pid": 0, "tid": 0,
                    "args": dict(args)})

    def spans(self, cat: Optional[str] = None) -> List[Dict[str, Any]]:
        """Recorded events, optionally filtered by category."""
        if cat is None:
            return list(self.events)
        return [e for e in self.events if e.get("cat") == cat]

    def to_chrome_trace(self) -> Dict[str, Any]:
        """The Perfetto-loadable trace document (Chrome trace-event JSON)."""
        meta = [{"name": "process_name", "ph": "M", "pid": 0, "tid": 0,
                 "args": {"name": self.process_name}}]
        return {"displayTimeUnit": "ms",
                "traceEvents": meta + self.events,
                "otherData": {"dropped_events": self.dropped}}

    def write(self, path: str) -> str:
        """Atomically publish the trace document to `path`."""
        d = os.path.dirname(path) or "."
        os.makedirs(d, exist_ok=True)
        fd, tmp = tempfile.mkstemp(dir=d, suffix=".tmp")
        try:
            with os.fdopen(fd, "w") as f:
                json.dump(self.to_chrome_trace(), f, indent=1)
            os.replace(tmp, path)
        except BaseException:
            if os.path.exists(tmp):
                os.unlink(tmp)
            raise
        return path


_TRACER: Optional[Tracer] = None


def set_tracer(tracer: Optional[Tracer]) -> None:
    global _TRACER
    _TRACER = tracer


def get_tracer() -> Optional[Tracer]:
    return _TRACER


@contextlib.contextmanager
def tracing(tracer: Tracer) -> Iterator[Tracer]:
    """Scoped install (tests); launchers use set_tracer directly."""
    prev = _TRACER
    set_tracer(tracer)
    try:
        yield tracer
    finally:
        set_tracer(prev)


@contextlib.contextmanager
def maybe_span(name: str, cat: str = CAT_STEP,
               **args: Any) -> Iterator[Optional[Dict[str, Any]]]:
    """`tracer.span(...)` when a tracer is installed, else a no-op."""
    tracer = get_tracer()
    if tracer is None:
        yield None
    else:
        with tracer.span(name, cat=cat, **args) as span_args:
            yield span_args
