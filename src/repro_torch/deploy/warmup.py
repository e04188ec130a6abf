"""Shared launcher warm-up: one place for the plan-cache CLI flags and the
planner construction both `launch.serve` and `launch.sweep` use, so the two
entry points cannot drift apart.
"""
from __future__ import annotations

import time
from typing import List, Sequence

from repro_torch.core.schedule import GEMMShape

from repro_torch.deploy.bucketing import bucket_of
from repro_torch.deploy.cache import PlanCache
from repro_torch.deploy.planner import Planner


def add_plan_args(ap) -> None:
    """The launcher flags controlling plan-cache warm-up."""
    ap.add_argument("--plan-cache", default="results/plan_cache",
                    help="directory for persisted deployment plans")
    ap.add_argument("--plan-grid", type=int, nargs=2, default=(4, 4),
                    metavar=("R", "C"),
                    help="pod grid the plans are tuned for")
    ap.add_argument("--plan-candidates", type=int, default=12,
                    help="autotuner search width during warm-up")
    ap.add_argument("--skip-plan-warmup", action="store_true")
    ap.add_argument("--no-online-tune", action="store_true",
                    help="disable online (analytic-shortlist) tuning of "
                         "plan_cached misses — cold shapes fall back to the "
                         "auto dataflow instead")


def build_planner(cache_dir: str, grid, max_candidates: int,
                  dataflows=None, calibration=None,
                  online_tune: bool = True) -> Planner:
    """A Planner on the pod-view accelerator with a persistent cache.

    `dataflows` restricts the candidate search (the restricted plans live
    under their own cache variant) — `dryrun --route-dataflows` uses it to
    force e.g. Fig. 6c schedules into the cache for the routed proof.

    A persisted calibration profile for this hardware fingerprint (written
    by `dryrun --calibrate` next to the plans) is loaded automatically, so
    every launcher that warms from the cache dir tunes with the measured
    cost model; pass `calibration` explicitly to override (or
    `calibration=False` to force the analytical prior).

    `online_tune=False` (the `--no-online-tune` flag) disables the analytic
    shortlist on `plan_cached` misses, restoring the pre-online behaviour
    where cold shapes degrade to the auto dataflow.
    """
    from repro_torch.hw.config import tpu_pod_as_accelerator
    from repro_torch.sim.calibrate import load_profile
    hw = tpu_pod_as_accelerator(tuple(grid))
    if calibration is None:
        calibration = load_profile(cache_dir, hw)
    elif calibration is False:
        calibration = None
    return Planner(hw, cache=PlanCache(cache_dir),
                   max_candidates=max_candidates,
                   dataflows=dataflows,
                   calibration=calibration,
                   online_tune=online_tune)


def warm_buckets(planner: Planner,
                 workload: Sequence[GEMMShape]) -> List[GEMMShape]:
    """Batch-tune the deduplicated pow-2 buckets of a GEMM workload and
    print the one-line warm-up summary. Returns the bucket list."""
    t0 = time.time()
    buckets = list(dict.fromkeys(bucket_of(s, planner.policy)
                                 for s in workload))
    planner.batch_tune(buckets, skip_illegal=planner.dataflows is not None)
    print(f"plan cache: {len(dict.fromkeys(workload))} workload shapes -> "
          f"{len(buckets)} buckets warmed in {time.time()-t0:.2f}s on "
          f"{planner.hw.name} ({planner.cache.stats.describe()})",
          flush=True)
    return buckets
