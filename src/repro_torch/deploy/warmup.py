"""Shared launcher warm-up: one place for the plan-cache CLI flags and the
planner construction both `launch.serve` and `launch.sweep` use, so the two
entry points cannot drift apart.
"""
from __future__ import annotations

import math
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
                    help="TPU pod grid the plans are tuned for on a CPU "
                         "mesh (a CUDA mesh prices the H100 card view at "
                         "its card count)")
    ap.add_argument("--plan-candidates", type=int, default=12,
                    help="autotuner search width during warm-up")
    ap.add_argument("--skip-plan-warmup", action="store_true")
    ap.add_argument("--no-online-tune", action="store_true",
                    help="disable online (analytic-shortlist) tuning of "
                         "plan_cached misses — cold shapes fall back to the "
                         "auto dataflow instead")


def plan_view(grid, device=None, mesh=None):
    """The accelerator the planner prices plans on: the view of the device
    the GEMMs run on. On a CUDA device, the card view
    (`h100_as_accelerator`) at the card count: `mesh`'s rows x its `model`
    columns, or with no mesh the host mesh `make_host_mesh` lays out (the
    process group's world x 1). Elsewhere (a CPU mesh), the reference's
    TPU pod view at `grid` (`--plan-grid`), so a CPU run plans exactly as
    the reference does. The two views' fingerprints differ, so their plans
    never share a cache entry."""
    import torch
    from repro_torch.hw.config import (h100_as_accelerator,
                                       tpu_pod_as_accelerator)
    if mesh is not None:
        device = mesh.device
    if device is None or torch.device(device).type != "cuda":
        return tpu_pod_as_accelerator(tuple(grid))
    if mesh is not None:
        cols = int(mesh.shape.get("model", 1))
        return h100_as_accelerator((math.prod(mesh.shape.values()) // cols,
                                    cols))
    import torch.distributed as dist
    world = (dist.get_world_size()
             if dist.is_available() and dist.is_initialized() else 1)
    return h100_as_accelerator((world, 1))


def build_planner(cache_dir: str, grid, max_candidates: int,
                  dataflows=None, calibration=None,
                  online_tune: bool = True, device=None,
                  mesh=None) -> Planner:
    """A Planner on the view of `device` (or `mesh`'s device; `plan_view`)
    with a persistent cache: the H100 card view on a CUDA device, the
    reference's TPU pod view at `grid` otherwise.

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
    from repro_torch.sim.calibrate import load_profile
    hw = plan_view(grid, device, mesh)
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
