"""One run of one cell: set-up, the measured window, with `--trace 1` the
profiled sub-windows and the per-layer readers, then the output check
against the plain reference, and the result line.
"""
from __future__ import annotations

import sys
import time
from typing import Any, Callable, Dict, List, Optional

from bench.harness import core, trace


class Run:
    """What the metric readers read: the cell, its configuration, the
    set-up seconds, the measured window's record (`seconds` and the work
    done: `flops`, `bytes`, `tokens`, `steps`, `calls`, `dtype`), and in a
    traced run the profiled sub-windows (`device_window`, device only;
    `host_window`, host activity traced too), the work each ran
    (`traced_gemms`: the GEMM calls, or None; `traced_units`: rounds or
    steps) and the host's dispatch spans (`dispatch_us`)."""

    def __init__(self, name: str, cell: Dict, config: Dict, seed: int):
        self.name, self.cell, self.config, self.seed = name, cell, config, seed
        self.setup_s: float = 0.0
        self.window: Dict[str, Any] = {}
        self.device_window: Optional[trace.Window] = None
        self.host_window: Optional[trace.Window] = None
        self.traced_gemms = None
        self.traced_units = 0
        self.dispatch_us: List[float] = []


def read_metrics(run: Run, specs: List[Dict]) -> Dict[str, Dict]:
    """Each metric's reader on the run; a reader that finds nothing to read
    returns None and leaves its metric out."""
    out = {}
    for spec in specs:
        value = core.load_module("metrics", spec["name"]).read(run)
        if value is not None:
            out[spec["name"]] = {"value": float(value), "unit": spec["unit"]}
    return out


def execute(name: str, seed: int, seconds: float, traced: bool,
            device: str = "cuda", cell: Optional[Dict] = None,
            config: Optional[Dict] = None,
            patch: Optional[Callable] = None,
            out=sys.stdout, err=sys.stderr) -> Dict:
    """Run cell `name` once and print its result line last on `out`; the
    checks' lines go last to `err`. `cell` and `config` replace the
    files the name would find and `patch(traffic)` may break the timed
    path underneath (the tests' small sizes and planted faults)."""
    import torch

    cell = cell or core.load_json("workloads", name)
    config = config or core.load_json("configs", cell["config"])
    spec = core.benchmark_spec()
    traffic = core.load_module("traffic", cell["generator"]).Traffic(
        cell, config, seed, device)
    if patch is not None:
        patch(traffic)
    dev = torch.device(device)
    run = Run(name, cell, config, seed)

    imported = core.process_seconds()
    traffic.setup()
    run.setup_s = core.process_seconds()
    run.window = traffic.window(seconds)
    if traced:
        units = run.window.get("rounds") or run.window.get("steps") or 1
        per_unit = run.window["seconds"] / units
        if hasattr(traffic, "dispatch_us"):
            run.dispatch_us = traffic.dispatch_us()
        body, gemms, run.traced_units = traffic.trace_body(per_unit)
        run.traced_gemms = gemms
        if dev.type == "cuda":
            run.device_window = trace.traced(torch, dev, body, host=False)
            run.host_window = trace.traced(torch, dev, body, host=True)
    peak = (torch.cuda.max_memory_allocated(dev) if dev.type == "cuda"
            else 0)
    key = "per_layer" if traced else "end_to_end"
    metrics = read_metrics(run, core.cell_metrics(spec, name, key))
    device_info = {"platform": "gpu" if dev.type == "cuda" else dev.type,
                   "kind": (torch.cuda.get_device_name(dev)
                            if dev.type == "cuda" else "cpu"),
                   "count": int(cell["chips"]),
                   "memory_peak_bytes": int(peak)}
    breakdown = None
    if traced and run.device_window is not None:
        w = run.device_window
        device_info["busy_s"] = w.busy / 1e6
        device_info["window_s"] = w.window_us / 1e6
        breakdown = {"device_ops": w.device_ops(),
                     "idle_gaps": run.host_window.idle_gaps()}

    traffic.release()
    t0 = time.perf_counter()
    checks, failed = traffic.check(cell["limits"])
    check_s = time.perf_counter() - t0
    barred = core.barred_modules()
    if barred:
        print(f"bench: the run holds barred modules {barred}", file=err,
              flush=True)
        raise SystemExit(3)
    correct = all(c.ok for c in checks)
    split = ", ".join(f"{k} {v:.3f} s" for k, v in
                      getattr(traffic, "setup_split", {}).items())
    print(f"bench: {name} seed {seed}: set-up {run.setup_s:.3f} s (process "
          f"start and imports {imported:.3f} s, {split}), window "
          f"{run.window['seconds']:.3f} s, check {check_s:.3f} s",
          file=err, flush=True)
    for c in checks:
        print(c.line(), file=err, flush=True)
    print(core.result_line(correct, traffic.attempted, failed, metrics,
                           device_info, checks, breakdown), file=out,
          flush=True)
    return {"correct": correct, "metrics": metrics, "checks": checks,
            "run": run}
