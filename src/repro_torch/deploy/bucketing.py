"""Shape bucketing: serve unseen GEMM shapes from nearby tuned plans.

Serving traffic produces a long tail of GEMM shapes (every batch size x
sequence length x projection), but mapping decisions transfer across nearby
shapes — the schedule space is driven by aspect ratio and magnitude, not the
exact dimension values. The bucketing layer exploits that:

- `bucket_of` rounds each dimension up to a power of two (capped, so one
  bucket covers the whole saturated regime) — the canonical shape a tuning
  run is amortized over;
- `nearest_tuned` ranks already-tuned shapes by log-space distance;
- `adapt` re-targets a tuned schedule to the requested shape, keeping the
  (grid, dataflow, remap) decision and re-deriving shape-dependent pieces
  (K-chunk clamp, default layouts), rejecting the transfer when the tiling
  does not legally divide the new shape.

A bucketed plan is always *checked* (legality via `build_program`, cost via
`estimate`) before being served; only the candidate *search* is skipped.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Iterable, List, Optional

from repro_torch.core.schedule import GEMMShape, Schedule
from repro_torch.hw.config import AcceleratorConfig


def next_pow2(x: int) -> int:
    return 1 << max(0, (x - 1).bit_length())


@dataclasses.dataclass(frozen=True)
class BucketingPolicy:
    """Knobs for the bucketed-serving path."""
    # dimensions round up to pow-2 buckets, saturating at this cap (a GEMM
    # with M = 1M tokens schedules like M = dim_cap: the grid just iterates).
    dim_cap: int = 8192
    # maximum sum of per-dim |log2| distances for a transfer to be attempted.
    max_distance: float = 3.0
    # how many adaptable sources a bucketed lookup prices before picking the
    # best (each costs one build+estimate, not a search).
    max_transfers: int = 3
    # bucketed estimate must be within (1 + tolerance) of a fresh tune for
    # `validate_transfer` to bless it (used by tests and refinement).
    tolerance: float = 0.25


def bucket_of(shape: GEMMShape,
              policy: BucketingPolicy = BucketingPolicy()) -> GEMMShape:
    """The canonical tuning shape for `shape` (pow-2 rounded, capped)."""
    return GEMMShape(m=min(next_pow2(shape.m), policy.dim_cap),
                     n=min(next_pow2(shape.n), policy.dim_cap),
                     k=min(next_pow2(shape.k), policy.dim_cap))


def distance(a: GEMMShape, b: GEMMShape) -> float:
    """Log-space L1 distance between two shapes (0 == identical)."""
    return (abs(math.log2(a.m / b.m)) + abs(math.log2(a.n / b.n))
            + abs(math.log2(a.k / b.k)))


def nearest_tuned(shape: GEMMShape, pool: Iterable[GEMMShape],
                  policy: BucketingPolicy = BucketingPolicy()
                  ) -> List[GEMMShape]:
    """Tuned shapes worth attempting a transfer from, nearest first."""
    ranked = sorted((cand for cand in pool if cand != shape),
                    key=lambda cand: distance(shape, cand))
    return [cand for cand in ranked
            if distance(shape, cand) <= policy.max_distance]


def adapt(schedule: Schedule, shape: GEMMShape,
          hw: AcceleratorConfig) -> Optional[Schedule]:
    """Re-target `schedule` to `shape`; None if the tiling doesn't transfer.

    Keeps the tuned decision (logical grid, iteration factors, dataflow,
    remap, buffering) and re-derives the shape-dependent parts: the K-chunk
    is re-clamped to the new K_local, and pinned layouts are dropped so
    `resolve_layouts` regenerates defaults for the new matrix shapes. Only
    tiling divisibility is checked here — the caller prices the result with
    `build_program` + `estimate`, which performs the full legality check
    (L1 capacity included) as a side effect.
    """
    tiling = schedule.tiling
    if tiling.gk == 0 or shape.k % tiling.gk:
        return None
    k_local = shape.k // tiling.gk
    tk = min(tiling.tk, k_local)
    while k_local % tk and tk > 1:
        tk //= 2                  # largest pow-2 chunk dividing K_local
    if k_local % tk:
        return None
    cand = dataclasses.replace(
        schedule, shape=shape,
        tiling=dataclasses.replace(tiling, tk=tk),
        layouts=None)
    try:
        cand.tiling.validate(shape, hw.n_tiles)
    except ValueError:
        return None
    return cand


def transfer_candidates(shape: GEMMShape, pool: Iterable[GEMMShape],
                        policy: BucketingPolicy = BucketingPolicy()
                        ) -> List[GEMMShape]:
    """Search order for a bucketed lookup: the exact bucket first, then the
    nearest tuned neighbours."""
    bucket = bucket_of(shape, policy)
    pool = list(pool)
    out: List[GEMMShape] = [s for s in (bucket,) if s in pool and s != shape]
    out += [s for s in nearest_tuned(shape, pool, policy) if s not in out]
    return out
