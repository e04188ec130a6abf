"""DeploymentPlan: the persistable artifact of one autotuning run.

A plan bundles everything dispatch needs to reuse a tuning decision without
re-running the search: the winning `Schedule`, the cost-model `PerfReport`
that justified it, and a fingerprint of the `AcceleratorConfig` it was tuned
for (a plan is only valid on the hardware it was priced against). Plans are
JSON documents with an explicit schema version so a persisted cache survives
code evolution — readers reject versions they don't understand instead of
silently deserializing garbage.
"""
from __future__ import annotations

import dataclasses
import functools
import hashlib
import json
from typing import Any, Dict

from repro_torch.core import layout as layout_lib
from repro_torch.core.remap import ClusterRemap
from repro_torch.core.schedule import (ATTN_DATAFLOW, AttnSchedule, AttnShape,
                                 GEMMShape, InnerKernel, Schedule, Tiling)
from repro_torch.hw.config import AcceleratorConfig
from repro_torch.sim.perf import PerfReport

# Bump whenever the serialized layout below changes incompatibly.
PLAN_SCHEMA_VERSION = 1

# How the plan was produced: a full candidate search, adapted from a nearby
# tuned bucket, or priced online from the closed-form analytic shortlist
# (core/analytic.py). Bucketed and analytic plans are candidates for
# background refinement — only a full search settles the question.
SOURCE_TUNED = "tuned"
SOURCE_BUCKETED = "bucketed"
SOURCE_ANALYTIC = "analytic"


@functools.lru_cache(maxsize=64)
def hw_fingerprint(hw: AcceleratorConfig) -> str:
    """Stable digest of every field that affects schedule legality or cost.

    Cached per config instance value (frozen dataclass, hashable) — this is
    on the per-GEMM dispatch path, so it must not re-serialize every call.
    """
    blob = json.dumps(dataclasses.asdict(hw), sort_keys=True)
    return hashlib.sha256(blob.encode()).hexdigest()[:16]


# ---------------------------------------------------------------------------
# Schedule <-> dict
# ---------------------------------------------------------------------------

def _layout_to_dict(lay: layout_lib.DataLayout) -> Dict[str, Any]:
    return {"split": [lay.split.grid_m, lay.split.grid_n],
            "placement": [lay.placement.tm, lay.placement.tn],
            "n_channels": lay.n_channels, "phase": lay.phase}


def _layout_from_dict(d: Dict[str, Any]) -> layout_lib.DataLayout:
    return layout_lib.DataLayout(
        split=layout_lib.SplitScheme(*d["split"]),
        placement=layout_lib.PlacementScheme(*d["placement"]),
        n_channels=d["n_channels"], phase=d["phase"])


def schedule_to_dict(sched: Schedule) -> Dict[str, Any]:
    if isinstance(sched, AttnSchedule):
        # discriminated by "kind" — absent means GEMM, so pre-attention
        # plan files keep loading under the same schema version
        s = sched.shape
        return {
            "kind": "attention",
            "shape": [s.b, s.sq, s.skv, s.h, s.hkv, s.d, s.dv,
                      int(s.causal)],
            "composition": sched.composition,
            "kv_chunk": sched.kv_chunk,
            "dataflow": sched.dataflow,
            "elem_bytes": sched.elem_bytes,
            "elem_dtype": sched.elem_dtype,
        }
    return {
        "shape": [sched.shape.m, sched.shape.n, sched.shape.k],
        "tiling": [sched.tiling.gm, sched.tiling.gn, sched.tiling.gk,
                   sched.tiling.iter_m, sched.tiling.iter_n, sched.tiling.tk],
        "dataflow": sched.dataflow,
        "remap": ([list(sched.remap.physical), list(sched.remap.logical)]
                  if sched.remap else None),
        "layouts": ({k: _layout_to_dict(v) for k, v in sched.layouts.items()}
                    if sched.layouts else None),
        "double_buffer": sched.double_buffer,
        "store_stages": sched.store_stages,
        "inner": list(sched.inner),
        "reduce_owner": sched.reduce_owner,
        "elem_bytes": sched.elem_bytes,
        "acc_bytes": sched.acc_bytes,
        "elem_dtype": sched.elem_dtype,
        "inner_kernel": (sched.inner_kernel.to_dict()
                         if sched.inner_kernel is not None else None),
        "overlap": sched.overlap,
    }


def schedule_from_dict(d: Dict[str, Any]) -> Schedule:
    if d.get("kind") == "attention":
        b, sq, skv, h, hkv, dd, dv, causal = d["shape"]
        return AttnSchedule(
            shape=AttnShape(b=int(b), sq=int(sq), skv=int(skv), h=int(h),
                            hkv=int(hkv), d=int(dd), dv=int(dv),
                            causal=bool(causal)),
            composition=d["composition"],
            kv_chunk=int(d["kv_chunk"]),
            dataflow=d.get("dataflow", ATTN_DATAFLOW),
            elem_bytes=int(d["elem_bytes"]),
            elem_dtype=d.get("elem_dtype", ""))
    remap = None
    if d.get("remap"):
        phys, logi = d["remap"]
        remap = ClusterRemap(tuple(phys), tuple(logi))
    layouts = None
    if d.get("layouts"):
        layouts = {k: _layout_from_dict(v) for k, v in d["layouts"].items()}
    return Schedule(
        shape=GEMMShape(*d["shape"]),
        tiling=Tiling(*d["tiling"]),
        dataflow=d["dataflow"],
        remap=remap,
        layouts=layouts,
        double_buffer=d["double_buffer"],
        store_stages=d["store_stages"],
        inner=tuple(d["inner"]),
        reduce_owner=d["reduce_owner"],
        elem_bytes=d["elem_bytes"],
        acc_bytes=d["acc_bytes"],
        # two-level fields: absent in pre-inner-kernel plans (same schema
        # version — readers tolerate their absence, writers always emit)
        elem_dtype=d.get("elem_dtype", ""),
        inner_kernel=(InnerKernel.from_dict(d["inner_kernel"])
                      if d.get("inner_kernel") else None),
        overlap=bool(d.get("overlap", False)),
    )


# ---------------------------------------------------------------------------
# The plan artifact
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class DeploymentPlan:
    schedule: Schedule
    report: PerfReport
    hw_name: str
    hw_digest: str
    source: str = SOURCE_TUNED
    candidates_tried: int = 0
    schema_version: int = PLAN_SCHEMA_VERSION
    # search-space variant this plan was tuned under ("" = unrestricted).
    # Part of the cache key: a dataflow-restricted search must not collide
    # with (or clobber) the unrestricted winner for the same shape.
    variant: str = ""
    # digest of the trusted CalibrationProfile that ranked the candidate
    # search ("" = ranked by the analytical prior). Provenance, not a cache
    # key: a calibrated re-tune intentionally replaces the prior's winner.
    calibration_digest: str = ""

    @property
    def shape(self) -> GEMMShape:
        return self.schedule.shape

    @property
    def elem_bytes(self) -> int:
        return self.schedule.elem_bytes

    def to_dict(self) -> Dict[str, Any]:
        return {
            "schema_version": self.schema_version,
            "hw_name": self.hw_name,
            "hw_digest": self.hw_digest,
            "source": self.source,
            "candidates_tried": self.candidates_tried,
            "variant": self.variant,
            "calibration_digest": self.calibration_digest,
            "schedule": schedule_to_dict(self.schedule),
            "report": self.report.to_dict(),
        }

    def to_json(self) -> str:
        return json.dumps(self.to_dict(), indent=1, sort_keys=True)

    @classmethod
    def from_dict(cls, d: Dict[str, Any]) -> "DeploymentPlan":
        version = d.get("schema_version")
        if version != PLAN_SCHEMA_VERSION:
            raise ValueError(f"plan schema version {version!r} not supported "
                             f"(reader is at {PLAN_SCHEMA_VERSION})")
        return cls(
            schedule=schedule_from_dict(d["schedule"]),
            report=PerfReport.from_dict(d["report"]),
            hw_name=d["hw_name"],
            hw_digest=d["hw_digest"],
            source=d.get("source", SOURCE_TUNED),
            candidates_tried=d.get("candidates_tried", 0),
            schema_version=version,
            variant=d.get("variant", ""),
            calibration_digest=d.get("calibration_digest", ""),
        )

    @classmethod
    def from_json(cls, text: str) -> "DeploymentPlan":
        return cls.from_dict(json.loads(text))

    def digest(self) -> str:
        """Stable id of this exact plan (schedule + report + provenance) —
        recorded in dispatch spans / run reports so a serve trace can be
        matched to the persisted artifact that produced it."""
        return hashlib.sha256(self.to_json().encode()).hexdigest()[:12]

    def valid_for(self, hw: AcceleratorConfig) -> bool:
        return self.hw_digest == hw_fingerprint(hw)

    def describe(self) -> str:
        s = self.shape
        head = (s.describe() if hasattr(s, "skv")
                else f"{s.m}x{s.n}x{s.k}")
        return (f"plan[{head} e{self.elem_bytes} {self.source} "
                f"@{self.hw_name}] {self.schedule.describe()} "
                f"est={self.report.total_time*1e6:.1f}us")


def plan_from_tuning(shape: GEMMShape, hw: AcceleratorConfig,
                     schedule: Schedule, report: PerfReport,
                     candidates_tried: int = 0,
                     source: str = SOURCE_TUNED,
                     variant: str = "",
                     calibration_digest: str = "") -> DeploymentPlan:
    assert schedule.shape == shape
    return DeploymentPlan(schedule=schedule, report=report, hw_name=hw.name,
                          hw_digest=hw_fingerprint(hw), source=source,
                          candidates_tried=candidates_tried, variant=variant,
                          calibration_digest=calibration_digest)


def plan_admissible(plan: DeploymentPlan, dataflows,
                    calibration_digest: str) -> bool:
    """THE cache-hit admissibility rule, shared by `deploy.Planner` and
    `core.autotuner.tune_cached` so the two entry points cannot disagree:
    a plan outside the caller's dataflow space (hand-edited cache dir), or
    ranked under a different calibration regime (analytical plans after a
    trusted profile landed, or vice versa), is a miss — it gets re-tuned
    and replaced, never silently served."""
    df = plan.schedule.dataflow
    # a dataflow-restricted GEMM search space does not constrain attention
    # plans — flat_attention is its own (single-dataflow) space, priced by
    # the same calibration regime
    if dataflows is not None and df not in dataflows and df != ATTN_DATAFLOW:
        return False
    return plan.calibration_digest == calibration_digest


def search_variant(dataflows) -> str:
    """Cache-key tag for a restricted dataflow search ('' = unrestricted).

    An empty list counts as unrestricted — that is what the autotuner's
    `dataflows or [...]` default makes it mean.
    """
    if not dataflows:
        return ""
    return hashlib.sha256(",".join(sorted(dataflows)).encode()).hexdigest()[:8]
