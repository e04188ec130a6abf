"""Versioned machine-readable run reports (jax-free).

Everything the launchers used to report print-only — routing counters,
executed modes, degrade reasons, workload coverage, calibration fit
quality, drift — lands in one `run_report.json` document that CI asserts
on directly instead of scraping stdout. The human-facing prints re-render
from the SAME dict (`describe_routing`, `render_run_report`), so the two
surfaces cannot drift apart.

Schema (see docs/observability.md for the field-by-field reference):

    {
      "schema_version": 1,
      "launcher": "serve" | "train" | "dryrun",
      "routing":     GemmStats.to_dict()         (counters + modes +
                                                  degrades + observed),
      "workload":    coverage section            (optional),
      "drift":       DriftMonitor.summary()      (optional),
      "calibration": fit-quality section         (optional),
      "dispatches":  per-pmm-span provenance     (optional, from the
                                                  tracer),
      "metrics":     MetricsRegistry.to_dict()   (optional),
      "serving":     SLO/goodput section         (optional, written by
                                                  `serve --traffic`; see
                                                  docs/serving.md),
      ...extra launcher-specific keys
    }
"""
from __future__ import annotations

import json
import os
import tempfile
from typing import Any, Dict, List, Optional

RUN_REPORT_SCHEMA_VERSION = 1


def describe_routing(d: Dict[str, Any]) -> str:
    """The one-line routing summary, rendered from `GemmStats.to_dict()`.

    This is THE format of the launchers' `plan routing:` line —
    `GemmStats.describe()` delegates here, so the shutdown print and the
    run report are the same data by construction.
    """
    out = (f"pmm calls={d['calls']} routed={d['routed']} "
           f"(hits={d['hits']} bucketed={d['bucketed']} "
           f"analytic={d.get('analytic', 0)} "
           f"fallback={d['fallback']}) unrouted={d['unrouted']} "
           f"plan-resolve-rate={d['resolve_rate']:.0%}")
    if d.get("modes"):
        out += f" modes={dict(sorted(d['modes'].items()))}"
    if d.get("degrades") or d.get("silent_degrades"):
        out += (f" degrades={dict(sorted(d['degrades'].items()))} "
                f"silent={d['silent_degrades']}")
    return out


def dispatch_provenance(tracer) -> List[Dict[str, Any]]:
    """Per-dispatch provenance lifted from the tracer's pmm spans — the
    run report's `dispatches` section (tag, shape,
    hit/bucketed/analytic/fallback,
    plan + calibration digests, resolved mode, reasons, predicted cost)."""
    from repro_torch.obs.trace import CAT_PMM
    return [dict(e.get("args", {}), name=e["name"])
            for e in tracer.spans(CAT_PMM)]


def build_run_report(launcher: str, *,
                     stats: Optional[Dict[str, Any]] = None,
                     workload: Optional[Dict[str, Any]] = None,
                     drift: Optional[Dict[str, Any]] = None,
                     calibration: Optional[Dict[str, Any]] = None,
                     tracer=None,
                     extra: Optional[Dict[str, Any]] = None
                     ) -> Dict[str, Any]:
    """Assemble the versioned run-report dict; None sections are omitted."""
    report: Dict[str, Any] = {
        "schema_version": RUN_REPORT_SCHEMA_VERSION,
        "launcher": launcher,
    }
    if stats is not None:
        report["routing"] = stats
    if workload is not None:
        report["workload"] = workload
    if drift is not None:
        report["drift"] = drift
    if calibration is not None:
        report["calibration"] = calibration
    if tracer is not None:
        report["dispatches"] = dispatch_provenance(tracer)
        report["metrics"] = tracer.metrics.to_dict()
    if extra:
        report.update(extra)
    return report


def write_run_report(path: str, report: Dict[str, Any]) -> str:
    """Atomically publish a run report to `path`."""
    d = os.path.dirname(path) or "."
    os.makedirs(d, exist_ok=True)
    fd, tmp = tempfile.mkstemp(dir=d, suffix=".tmp")
    try:
        with os.fdopen(fd, "w") as f:
            json.dump(report, f, indent=1, sort_keys=True)
        os.replace(tmp, path)
    except BaseException:
        if os.path.exists(tmp):
            os.unlink(tmp)
        raise
    return path


def render_run_report(report: Dict[str, Any]) -> List[str]:
    """The human-facing shutdown lines, rendered from the report dict."""
    lines: List[str] = []
    routing = report.get("routing")
    if routing is not None:
        lines.append(f"plan routing: {describe_routing(routing)}")
        if routing.get("modes"):
            lines.append(f"lowered modes: "
                         f"{dict(sorted(routing['modes'].items()))}")
        if routing.get("degrades") or routing.get("silent_degrades"):
            lines.append(f"routing degrades (by reason): "
                         f"{dict(sorted(routing['degrades'].items()))} "
                         f"silent-auto={routing['silent_degrades']}")
    workload = report.get("workload")
    if workload is not None:
        lines.append(
            f"workload cross-validation: model_workload predicted "
            f"{workload['covered']:.0%} of the {workload['observed']} "
            f"executed GEMM shapes ({len(workload['extra'])} unpredicted, "
            f"{len(workload['missing'])} predicted-but-unexecuted)")
    serving = report.get("serving")
    if serving is not None:
        lines.append(
            f"serving [{serving['policy']}]: {serving['requests']} requests "
            f"goodput={serving['goodput_tps']:.1f} tok/s "
            f"p50={serving['p50_latency_s'] * 1e3:.1f}ms "
            f"p99={serving['p99_latency_s'] * 1e3:.1f}ms "
            f"miss={serving['deadline_miss_rate']:.0%} "
            f"cold-shapes={serving['cold_shapes']}")
    drift = report.get("drift")
    if drift is not None and drift.get("n_samples"):
        per_mode = {m: rec["geomean_ratio"]
                    for m, rec in drift["per_mode"].items()}
        stale = ("STALE — re-run calibration (dryrun --calibrate)"
                 if drift["profile_stale"] else "within threshold")
        lines.append(f"calibration drift: geomean measured/predicted="
                     f"{drift['geomean_ratio']} per-mode={per_mode} "
                     f"(threshold {drift['threshold']}: {stale})")
    return lines
