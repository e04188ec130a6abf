"""Runtime observability: structured dispatch tracing, Chrome trace-event
(Perfetto) export, a metrics registry, predicted-vs-measured drift
monitoring, and versioned run reports.

The whole package is importable without jax — only the dispatch path that
*feeds* it (models/matmul.py, core/gemm.py) touches jax. A launcher
installs a `Tracer` via `set_tracer` exactly like it installs the
`GemmContext`; with no tracer installed the hooks are a global read + None
check. See docs/observability.md.
"""
from repro_torch.obs.drift import DRIFT_STALE_THRESHOLD, DriftMonitor
from repro_torch.obs.metrics import MetricsRegistry
from repro_torch.obs.report import (RUN_REPORT_SCHEMA_VERSION, build_run_report,
                              describe_routing, dispatch_provenance,
                              render_run_report, write_run_report)
from repro_torch.obs.trace import (Tracer, get_tracer, maybe_span, set_tracer,
                             tracing)

__all__ = [
    "DRIFT_STALE_THRESHOLD", "DriftMonitor", "MetricsRegistry",
    "RUN_REPORT_SCHEMA_VERSION", "build_run_report", "describe_routing",
    "dispatch_provenance", "render_run_report", "write_run_report",
    "Tracer", "get_tracer", "maybe_span", "set_tracer", "tracing",
]
