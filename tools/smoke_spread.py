"""Median and spread of `chip_smoke.py`'s kernel timings over several runs.

    python3 tools/smoke_spread.py run1.log run2.log run3.log ...

Reads each run's standard output, takes the per-shape JSON rows of its
timing phase (each names its path: model and decode or train), and prints
per path and shape the median, min and max over the runs of the kernel's,
the plain version's and `torch.matmul`'s device time (us per call), the
bound, and the same per step of each path (ms: each shape's time times its
launches per step, summed). Needs no card.
"""
from __future__ import annotations

import json
import statistics
import sys
from collections import defaultdict

KEYS = ("kernel_ms", "plain_ms", "library_ms")


def rows(path):
    with open(path) as f:
        for line in f:
            if line.startswith("{") and '"kernel_ms"' in line:
                row = json.loads(line)
                if "shape" in row:      # not the `kernels` report line
                    yield row


def spread(xs):
    return {"median": statistics.median(xs), "min": min(xs), "max": max(xs)}


def main(paths) -> int:
    if not paths:
        print(__doc__, file=sys.stderr)
        return 2
    by_shape = defaultdict(lambda: defaultdict(list))
    steps = defaultdict(lambda: defaultdict(list))
    for path in paths:
        run = list(rows(path))
        if not run:
            print(f"{path}: no timing rows", file=sys.stderr)
            return 1
        for r in run:
            d = by_shape[r["path"], tuple(r["shape"])]
            d["launches_per_step"] = r["launches_per_step"]
            d["bound_us"] = [1e3 * r["bound_ms"]]
            for key in KEYS:
                d[key].append(1e3 * r[key])
        for path_ in {r["path"] for r in run}:
            for key in KEYS:
                steps[path_][key].append(sum(
                    r[key] * r["launches_per_step"] for r in run
                    if r["path"] == path_))
    for (path_, shape), d in by_shape.items():
        print(json.dumps({"path": path_, "shape": list(shape),
                          "runs": len(d["kernel_ms"]),
                          "launches_per_step": d["launches_per_step"],
                          "bound_us": d["bound_us"][0],
                          **{key.replace("_ms", "_us"): spread(d[key])
                             for key in KEYS}}))
    for path_, per_key in steps.items():
        print(json.dumps({"path": path_, "per_step_ms": {
            key: spread(v) for key, v in per_key.items()},
            "runs": len(paths)}))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
