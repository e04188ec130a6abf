"""What every cell's run shares: finding cells, configurations, traffic
generators and metric readers by name, seeds, the set-up clock, the guard
against the JAX reference package, and the result line.

Each piece of a cell is a file of its own, found by the name that
`BENCHMARK.json` or the cell gives it:

- a cell: `bench/workloads/<cell>.json` (configuration, traffic generator,
  traffic parameters, chips, why, and the limits of its correctness check);
- a configuration: `bench/configs/<config>.json`;
- a traffic generator: `bench/traffic/<generator>.py`, a `Traffic` class;
- a metric: `bench/metrics/<metric>.py`, a `read(run)` function that
  returns the metric's value, or None where the run holds nothing to read.
"""
from __future__ import annotations

import hashlib
import importlib.util
import json
import math
import os
import sys
import time
from pathlib import Path
from types import ModuleType
from typing import Any, Dict, List, Optional

BENCH = Path(__file__).resolve().parents[1]
ROOT = BENCH.parent

# top-level module names that no run of the port may hold: the JAX
# reference package and JAX itself, compared whole (`repro_torch` is the
# port, not `repro`)
BARRED_MODULES = ("jax", "jaxlib", "flax", "repro")


def load_json(kind: str, name: str) -> Dict[str, Any]:
    """`bench/<kind>/<name>.json`; an unknown name raises LookupError."""
    path = BENCH / kind / f"{name}.json"
    if not _plain_name(name) or not path.is_file():
        raise LookupError(f"no {kind} entry named {name!r} ({path})")
    return json.loads(path.read_text())


def load_module(kind: str, name: str) -> ModuleType:
    """`bench/<kind>/<name>.py` as a module (the file name may hold dots,
    as a metric's does); an unknown name raises LookupError."""
    path = BENCH / kind / f"{name}.py"
    if not _plain_name(name) or not path.is_file():
        raise LookupError(f"no {kind} entry named {name!r} ({path})")
    mod_name = f"bench_{kind}_" + name.replace(".", "_").replace("-", "_")
    spec = importlib.util.spec_from_file_location(mod_name, path)
    mod = importlib.util.module_from_spec(spec)
    sys.modules[mod_name] = mod
    spec.loader.exec_module(mod)
    return mod


def _plain_name(name: str) -> bool:
    return (0 < len(name) <= 64 and name[0] not in ".-"
            and all(c.isascii() and (c.isalnum() or c in "_.-")
                    for c in name))


def benchmark_spec() -> Dict[str, Any]:
    """The root `BENCHMARK.json`."""
    return json.loads((ROOT / "BENCHMARK.json").read_text())


def cell_metrics(spec: Dict[str, Any], cell: str, key: str
                 ) -> List[Dict[str, Any]]:
    """The `end_to_end` or `per_layer` metrics that `cell` reports: those
    that list it under `workloads`, and those with no `workloads` key."""
    return [m for m in spec[key] if cell in m.get("workloads", [cell])]


def derive_seed(seed: int, purpose: str) -> int:
    """A 63-bit generator seed for one use of a run's `--seed`, so that
    each use draws its own stream and any whole number is a valid seed."""
    digest = hashlib.sha256(f"{int(seed)}:{purpose}".encode()).digest()
    return int.from_bytes(digest[:8], "little") >> 1


def process_seconds() -> float:
    """Seconds since this process started (its start time from
    `/proc/self/stat`, against the boot clock)."""
    try:
        fields = Path("/proc/self/stat").read_text().rsplit(")", 1)[1].split()
        started = int(fields[19]) / os.sysconf("SC_CLK_TCK")
        return time.clock_gettime(time.CLOCK_BOOTTIME) - started
    except (OSError, ValueError, IndexError):
        return time.perf_counter() - _IMPORTED_AT


_IMPORTED_AT = time.perf_counter()


def barred_modules() -> List[str]:
    """The barred top-level module names this process holds."""
    held = {name.split(".", 1)[0] for name in list(sys.modules)}
    return sorted(held & set(BARRED_MODULES))


class Check:
    """One number compared with its limit: passes when it is finite and no
    more than the limit (a NaN fails)."""

    def __init__(self, name: str, value: float, limit: float, what: str):
        self.name, self.value, self.limit, self.what = (name, float(value),
                                                        float(limit), what)

    @property
    def ok(self) -> bool:
        return math.isfinite(self.value) and self.value <= self.limit

    def line(self) -> str:
        return (f"check {self.name}: {self.value!r} against limit "
                f"{self.limit!r} ({'ok' if self.ok else 'FAILED'}): "
                f"{self.what}")


def result_line(correct: bool, attempted: int, failed: int,
                metrics: Dict[str, Dict[str, Any]], device: Dict[str, Any],
                checks: List[Check],
                breakdown: Optional[Dict[str, Any]] = None) -> str:
    """The contract's last line, the checks' key last."""
    out: Dict[str, Any] = {"correct": bool(correct),
                           "attempted": int(attempted),
                           "failed": int(failed), "metrics": metrics,
                           "device": device}
    if breakdown is not None:
        out["breakdown"] = breakdown
    # a number that is not finite (a C that holds NaN) is printed as null,
    # so the line stays strict JSON
    out["checks"] = {c.name: {"value": c.value if math.isfinite(c.value)
                              else None, "limit": c.limit} for c in checks}
    return json.dumps(out, allow_nan=False)
