"""Launcher-installed execution context for the model stack.

Port of `repro/models/shard_ctx.py`. Two layers, both set by launchers
before the model runs and no-ops when absent:

1. **Activation-sharding context** (`set_mesh` / `constrain_tokens`): in
   the reference it pins the residual stream's (batch=dp) layout at every
   block boundary. In the port activations are whole on every rank of a
   pod (the mode bodies take their blocks and gather their outputs), so
   there is nothing to pin and `constrain_tokens` is the identity on every
   mesh. The sharded trainer splits the batch over the `pod` axis only
   (`set_mesh(mesh, pod_batch=True)`): the model then sees its pod's share
   of the global batch (`batch_pods`), which the MoE dispatch groups
   account for. The dry run installs its mesh over the whole batch.

2. **GEMM-routing context** (`set_gemm_context` / `GemmContext`): the mesh
   context extended into a full gemm context. It carries the device mesh plus
   the deployment `Planner` whose warmed plan cache decides how each model
   matmul executes (a `HostMesh` of one device or a `DistMesh` over a
   `torch.distributed` world); `repro_torch.models.matmul.pmm` consults it at trace time and
   dispatches through `repro_torch.core.gemm.dit_gemm`. The context also records
   every (tag, GEMMShape) the model actually traces — the ground truth that
   `repro_torch.deploy.planner.model_workload` is cross-validated against — and
   keeps routing stats (exact hit / bucketed / analytic online-tune /
   fallback) for the launcher's shutdown report. With no context installed, `pmm` is exactly `x @ w`, so
   smoke tests and meshless tracing are unchanged.

See docs/architecture.md for the full routing path.
"""
from __future__ import annotations

import contextlib
import dataclasses
from typing import Dict, Iterator, List, Optional, Tuple

import torch

_MESH: Optional[object] = None
_POD_BATCH = False


def set_mesh(mesh, pod_batch: bool = False) -> None:
    """Install `mesh` (None clears it). `pod_batch`: the model runs on its
    pod's rows of the global batch (the sharded trainer's split)."""
    global _MESH, _POD_BATCH
    _MESH, _POD_BATCH = mesh, pod_batch and mesh is not None


def get_mesh():
    return _MESH


def batch_pods() -> int:
    """How many pods the global batch is split over: the installed mesh's
    `pod` size under the sharded trainer, else 1."""
    if not _POD_BATCH:
        return 1
    return int(_MESH.shape.get("pod", 1))


# ---------------------------------------------------------------------------
# GEMM-routing context
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class GemmStats:
    """Routing counters + the observed (tag, shape) workload.

    The reference counts per *traced* `pmm` call (jit consults the planner
    once per callsite per trace). Eager PyTorch has no trace, so the port
    resolves — and counts — each (tag, shape) once per `GemmContext`;
    `observed` maps (tag, GEMMShape) -> resolution count and is the
    model-side record that `model_workload` predictions are checked
    against. `executed_gemm` / `executed_attn` count the routed dispatches
    actually run (one per call), which a trace-time count cannot see.
    """
    hits: int = 0          # served a fully-tuned plan
    bucketed: int = 0      # served a bucket-transferred plan
    analytic: int = 0      # served an online-tuned (analytic shortlist) plan
    fallback: int = 0      # no usable plan -> auto dataflow
    unrouted: int = 0      # recorded but not routed (no mesh in the context)
    unroutable: int = 0    # pmm calls that are not a single dense GEMM
    #                        (batched weights etc.) — recorded, never routed
    observed: Dict[Tuple[str, object], int] = dataclasses.field(
        default_factory=dict)
    # attention dispatches (pattn) keep a separate observed map: the GEMM
    # `observed` feeds `workload_coverage`/`observed_shapes`, whose consumers
    # sort on (m, n, k) and rebuild `GEMMShape(*shape)` — an AttnShape there
    # would crash them. Keys are (tag, AttnShape).
    attn_observed: Dict[Tuple[str, object], int] = dataclasses.field(
        default_factory=dict)
    # schedule->mesh lowering outcomes (repro_torch.core.lower.ExecPlan): which
    # mode each plan-served matmul actually executed, and the
    # machine-readable reason for every degradation along the way
    modes: Dict[str, int] = dataclasses.field(default_factory=dict)
    degrades: Dict[str, int] = dataclasses.field(default_factory=dict)
    silent_degrades: int = 0   # auto executions with NO recorded reason
    #                            (structurally 0: every ExecPlan fallback
    #                            carries a reason; kept as the cross-check)
    executed_gemm: int = 0     # routed pmm dispatches run (per call)
    executed_attn: int = 0     # routed pattn dispatches run (per call)

    def record(self, tag: str, shape, count: int = 1) -> None:
        """`count` > 1 logs one traced call that stands for `count` GEMMs of
        this shape (MLA's absorbed form runs n_heads per-head contractions
        in one einsum)."""
        key = (tag, shape)
        self.observed[key] = self.observed.get(key, 0) + count

    def record_attn(self, tag: str, shape) -> None:
        key = (tag, shape)
        self.attn_observed[key] = self.attn_observed.get(key, 0) + 1

    def record_lowering(self, exec_plan) -> None:
        """Count an ExecPlan's executed mode + its fallback-chain reasons."""
        self.modes[exec_plan.mode] = self.modes.get(exec_plan.mode, 0) + 1
        for fb in exec_plan.fallbacks:
            self.degrades[fb.reason] = self.degrades.get(fb.reason, 0) + 1
        if exec_plan.mode == "auto" and not exec_plan.fallbacks:
            self.silent_degrades += 1

    @property
    def routed(self) -> int:
        return self.hits + self.bucketed + self.analytic + self.fallback

    @property
    def resolved(self) -> int:
        """Calls that found a plan — cached, bucketed, or online-tuned
        (the hit-rate numerator)."""
        return self.hits + self.bucketed + self.analytic

    @property
    def resolve_rate(self) -> float:
        return self.resolved / self.routed if self.routed else 0.0

    def observed_shapes(self) -> List[object]:
        """Deduplicated GEMMShapes the model actually traced."""
        return list(dict.fromkeys(shape for (_, shape) in self.observed))

    def to_dict(self) -> Dict[str, object]:
        """JSON-able snapshot — the run report's `routing` section.

        Counters plus derived summaries (`calls`, `routed`, `resolve_rate`)
        so report consumers never recompute them, and the observed
        (tag, shape) workload as a stable list. `from_dict` round-trips it.
        """
        return {
            "calls": self.routed + self.unrouted,
            "routed": self.routed,
            "hits": self.hits,
            "bucketed": self.bucketed,
            "analytic": self.analytic,
            "fallback": self.fallback,
            "unrouted": self.unrouted,
            "unroutable": self.unroutable,
            "resolve_rate": self.resolve_rate,
            "modes": dict(sorted(self.modes.items())),
            "degrades": dict(sorted(self.degrades.items())),
            "silent_degrades": self.silent_degrades,
            "executed": {"gemm": self.executed_gemm,
                         "attn": self.executed_attn},
            "observed": [
                {"tag": tag,
                 "shape": ([int(s.m), int(s.n), int(s.k)]
                           if hasattr(s, "m") else list(s)),
                 "count": count}
                for (tag, s), count in self.observed.items()],
            "attn_observed": [
                {"tag": tag,
                 "shape": [int(s.b), int(s.sq), int(s.skv), int(s.h),
                           int(s.hkv), int(s.d), int(s.dv),
                           int(s.causal)],
                 "count": count}
                for (tag, s), count in self.attn_observed.items()],
        }

    @classmethod
    def from_dict(cls, d: Dict[str, object]) -> "GemmStats":
        """Rebuild a stats object from `to_dict()` output (derived fields
        like `calls`/`routed`/`resolve_rate` are recomputed, not read)."""
        from repro_torch.core.schedule import AttnShape, GEMMShape
        stats = cls(hits=int(d["hits"]), bucketed=int(d["bucketed"]),
                    analytic=int(d.get("analytic", 0)),
                    fallback=int(d["fallback"]), unrouted=int(d["unrouted"]),
                    unroutable=int(d.get("unroutable", 0)),
                    modes=dict(d.get("modes", {})),
                    degrades=dict(d.get("degrades", {})),
                    silent_degrades=int(d.get("silent_degrades", 0)),
                    executed_gemm=int(d.get("executed", {}).get("gemm", 0)),
                    executed_attn=int(d.get("executed", {}).get("attn", 0)))
        for rec in d.get("observed", []):
            key = (rec["tag"], GEMMShape(*rec["shape"]))
            stats.observed[key] = int(rec["count"])
        for rec in d.get("attn_observed", []):
            b, sq, skv, h, hkv, dd, dv, causal = rec["shape"]
            key = (rec["tag"], AttnShape(b, sq, skv, h, hkv, dd, dv,
                                         bool(causal)))
            stats.attn_observed[key] = int(rec["count"])
        return stats

    def describe(self) -> str:
        # render from the dict so the print and the run report cannot drift
        from repro_torch.obs.report import describe_routing
        return describe_routing(self.to_dict())


@dataclasses.dataclass
class GemmContext:
    """What `pmm` needs to route a model matmul through `dit_gemm`.

    mesh=None makes the context record-only: every pmm call is logged in
    `stats.observed` but executes as plain `x @ w`.

    `resolved` memoizes, per (tag, shape), what the first dispatch decided
    (the lowered `ExecPlan`, or the fallback / unrouted outcome): this is
    the port's translation of jit's trace cache — the planner is consulted,
    the schedule lowered, the stats counted and the provenance span emitted
    once, and later calls dispatch straight from the memo.
    """
    mesh: Optional[object] = None
    planner: Optional[object] = None      # repro_torch.deploy.Planner (duck-typed)
    row_axis: str = "data"
    col_axis: str = "model"
    stats: GemmStats = dataclasses.field(default_factory=GemmStats)
    resolved: Dict[Tuple[str, object], object] = dataclasses.field(
        default_factory=dict)


_GEMM_CTX: Optional[GemmContext] = None


def set_gemm_context(ctx: Optional[GemmContext]) -> None:
    global _GEMM_CTX
    _GEMM_CTX = ctx


def get_gemm_context() -> Optional[GemmContext]:
    return _GEMM_CTX


@contextlib.contextmanager
def gemm_context(ctx: GemmContext) -> Iterator[GemmContext]:
    """Scoped install (tests); launchers use set_gemm_context directly."""
    prev = _GEMM_CTX
    set_gemm_context(ctx)
    try:
        yield ctx
    finally:
        set_gemm_context(prev)


def constrain_tokens(x: torch.Tensor) -> torch.Tensor:
    """(B, S, D) or (B, S): batch over the DP axes when it divides — the
    identity in the port, whose activations are whole on every rank."""
    return x
