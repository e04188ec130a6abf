"""Plan-routed matmul: the single funnel every dense model matmul goes
through, so deployment schedules — not hand-written call sites — decide how
each GEMM executes (the paper's core claim, applied to the model stack).

`pmm(x, w, tag=...)` is a drop-in replacement for `x @ w`:

- with no `GemmContext` installed it IS `x @ w`;
- with a record-only context (mesh=None) it additionally logs the
  (tag, GEMMShape) pair it would have routed;
- with a live mesh+planner context it flattens leading batch/seq dims to a
  2-D GEMM, consults the planner's warmed cache (exact hit, else bucketed
  transfer, else an online tune over the closed-form analytic shortlist),
  lowers the schedule and dispatches through `core.gemm.dit_gemm`. Shapes
  with no usable plan route through `dit_gemm`'s auto mode and are counted
  as fallbacks.

Trace-time semantics, translated. The reference consults the planner,
lowers and records stats at jit *trace* time, once per callsite per trace,
so routing costs nothing per executed step. Eager PyTorch has no trace:
called naively the planner would be consulted ~127 times per gemma-2b
token. So `pmm` and `pattn` resolve each (tag, shape) once per
`GemmContext` — lookup, lowering, stats and the provenance span — memoize
the outcome in `GemmContext.resolved` (the counterpart of jit's trace
cache), and dispatch straight from the memoized `ExecPlan` afterwards.
`GemmStats.executed_gemm` / `executed_attn` count the dispatches run.
"""
from __future__ import annotations

import math
import time

import torch

from repro_torch.core.schedule import AttnShape, GEMMShape
from repro_torch.models import shard_ctx
from repro_torch.obs import trace as obs_trace

# memo markers for outcomes that carry no ExecPlan
_UNROUTED = "unrouted"
_FALLBACK = "fallback"


def _gemm_shape(x: torch.Tensor, w: torch.Tensor) -> GEMMShape:
    """The 2-D problem `x @ w` solves: leading dims of x flatten into M."""
    return GEMMShape(m=int(math.prod(x.shape[:-1])), n=int(w.shape[-1]),
                     k=int(x.shape[-1]))


def _routable(x: torch.Tensor, w: torch.Tensor) -> bool:
    return (w.dim() == 2 and x.dim() >= 2 and x.shape[-1] == w.shape[0]
            and all(int(d) > 0 for d in x.shape))


def record_gemm(tag: str, m: int, n: int, k: int, count: int = 1) -> None:
    """Log a GEMM executed outside `pmm` (batched expert einsums etc.) so the
    observed workload covers everything the model runs."""
    ctx = shard_ctx.get_gemm_context()
    if ctx is not None and m > 0 and n > 0 and k > 0 and count > 0:
        ctx.stats.record(tag, GEMMShape(m, n, k), count=count)


def lookup_plan(planner, shape):
    """Dispatch-path plan lookup:
    (plan | None, 'hit' | 'bucketed' | 'analytic' | None).

    Never runs a full tune; classification follows the served plan's
    provenance ('hit' = born from a full tune)."""
    plan = planner.plan_cached(shape)
    if plan is None:
        return None, None
    source = getattr(plan, "source", "")
    kind = source if source in ("bucketed", "analytic") else "hit"
    return plan, kind


def _consult(ctx, shape, prov: dict, tracer, metric: str):
    """Plan consult + hit/bucketed/analytic counting (shared by both funnels)."""
    plan, kind = None, None
    if ctx.planner is not None:
        t0 = time.perf_counter()
        plan, kind = lookup_plan(ctx.planner, shape)
        resolve_us = (time.perf_counter() - t0) * 1e6
        prov["plan_resolve_us"] = round(resolve_us, 1)
        if tracer is not None:
            tracer.metrics.observe(metric, resolve_us)
        if kind == "hit":
            ctx.stats.hits += 1
        elif kind == "bucketed":
            ctx.stats.bucketed += 1
        elif kind == "analytic":
            ctx.stats.analytic += 1
    return plan, kind


def _plan_provenance(plan, prov: dict, tracer) -> None:
    report = getattr(plan, "report", None)
    if report is not None:
        prov["predicted_s"] = report.total_time
    if tracer is not None:
        if hasattr(plan, "digest"):
            prov["plan_digest"] = plan.digest()
        prov["calibration_digest"] = getattr(plan, "calibration_digest", "")


def _resolve_routed(ctx, shape: GEMMShape, prov: dict, tracer):
    """Plan consult -> lowering -> stats, once per (tag, shape). Returns the
    `ExecPlan`, or `_FALLBACK` when no plan resolved (auto dataflow)."""
    plan, kind = _consult(ctx, shape, prov, tracer, "pmm.plan_resolve_us")
    if plan is None:
        ctx.stats.fallback += 1
        # inner_kernel/overlap are part of the per-dispatch contract: every
        # dispatch record carries them (None/False = plain local GEMM)
        prov.update(provenance="fallback", mode="auto",
                    inner_kernel=None, overlap=False)
        return _FALLBACK
    from repro_torch.core.lower import lower_schedule
    exec_plan = lower_schedule(getattr(plan, "schedule", plan), ctx.mesh,
                               ctx.row_axis, ctx.col_axis, shape=shape)
    ctx.stats.record_lowering(exec_plan)
    prov.update(provenance=kind, mode=exec_plan.mode,
                reasons=list(exec_plan.reasons()),
                inner_kernel=(exec_plan.inner_kernel.to_dict()
                              if exec_plan.inner_kernel is not None else None),
                overlap=exec_plan.overlap)
    _plan_provenance(plan, prov, tracer)
    return exec_plan


def _dispatch_routed(ctx, x: torch.Tensor, w: torch.Tensor,
                     resolved) -> torch.Tensor:
    """Run one routed GEMM from its memoized resolution."""
    from repro_torch.core.gemm import dit_gemm   # lazy: keep cycles at bay
    ctx.stats.executed_gemm += 1
    if resolved is _FALLBACK:
        return dit_gemm(x, w, ctx.mesh, mode="auto", row_axis=ctx.row_axis,
                        col_axis=ctx.col_axis)
    return dit_gemm(x, w, ctx.mesh, row_axis=ctx.row_axis,
                    col_axis=ctx.col_axis, exec_plan=resolved)


def pmm(x: torch.Tensor, w: torch.Tensor, tag: str = "") -> torch.Tensor:
    """Plan-routed `x @ w`. x: (..., K); w: (K, N) -> (..., N)."""
    ctx = shard_ctx.get_gemm_context()
    if ctx is None:
        return x @ w
    if not _routable(x, w):
        # not a single dense GEMM this layer understands; stay out of the
        # way — but record it first, or the observed workload undercounts
        if (x.dim() >= 1 and w.dim() >= 2 and x.shape[-1] == w.shape[-2]
                and all(int(d) > 0 for d in x.shape)
                and all(int(d) > 0 for d in w.shape)):
            ctx.stats.record(tag, _gemm_shape(x, w))
        ctx.stats.unroutable += 1
        return x @ w
    shape = _gemm_shape(x, w)
    key = (tag, shape)
    resolved = ctx.resolved.get(key)
    if resolved is not None:
        if resolved is _UNROUTED:
            return x @ w
        return _dispatch_routed(ctx, x, w, resolved)

    # first call for this (tag, shape): the reference's trace-time work
    ctx.stats.record(tag, shape)
    tracer = obs_trace.get_tracer()
    if ctx.mesh is None:
        ctx.stats.unrouted += 1
        ctx.resolved[key] = _UNROUTED
        if tracer is not None:
            tracer.instant(f"pmm.{tag or 'untagged'}", tag=tag,
                           shape=[shape.m, shape.n, shape.k],
                           provenance="unrouted")
            tracer.metrics.counter("pmm.provenance.unrouted").inc()
        return x @ w
    if tracer is None:
        resolved = ctx.resolved[key] = _resolve_routed(ctx, shape, {}, None)
        return _dispatch_routed(ctx, x, w, resolved)
    # the span covers resolution plus the first dispatch, as the
    # reference's covers plan consult + lowering + tracing
    t0 = time.perf_counter()
    with tracer.span(f"pmm.{tag or 'untagged'}", cat=obs_trace.CAT_PMM,
                     tag=tag, shape=[shape.m, shape.n, shape.k]) as prov:
        resolved = ctx.resolved[key] = _resolve_routed(ctx, shape, prov,
                                                       tracer)
        out = _dispatch_routed(ctx, x, w, resolved)
    dispatch_us = (time.perf_counter() - t0) * 1e6
    tracer.metrics.counter(f"pmm.provenance.{prov['provenance']}").inc()
    tracer.metrics.observe(
        f"pmm.dispatch_us.mode.{prov.get('mode', 'auto')}", dispatch_us)
    tracer.metrics.observe(
        f"pmm.dispatch_us.tag.{tag or 'untagged'}", dispatch_us)
    return out


# ---------------------------------------------------------------------------
# pattn: the attention funnel (pmm's shape, applied to fused attention)
# ---------------------------------------------------------------------------

def _attn_shape(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                causal: bool) -> AttnShape:
    """q (b, sq, h, d); k (b, skv, hkv, d); v (b, skv, hkv, dv)."""
    b, sq, h, d = (int(s) for s in q.shape)
    skv, hkv = int(k.shape[1]), int(k.shape[2])
    return AttnShape(b=b, sq=sq, skv=skv, h=h, hkv=hkv, d=d,
                     dv=int(v.shape[-1]), causal=bool(causal))


def _resolve_attn(ctx, shape: AttnShape, prov: dict, tracer):
    """Plan consult -> lower_attention -> stats, once per (tag, shape).
    Returns the `ExecPlan` or `_FALLBACK` (the unfused path)."""
    plan, kind = _consult(ctx, shape, prov, tracer, "pattn.plan_resolve_us")
    if plan is None:
        ctx.stats.fallback += 1
        prov.update(provenance="fallback", mode="unfused_attn",
                    inner_kernel=None, overlap=False)
        return _FALLBACK
    from repro_torch.core.lower import lower_attention
    exec_plan = lower_attention(getattr(plan, "schedule", plan), ctx.mesh,
                                ctx.row_axis, ctx.col_axis, shape=shape)
    ctx.stats.record_lowering(exec_plan)
    prov.update(provenance=kind, mode=exec_plan.mode,
                reasons=list(exec_plan.reasons()),
                inner_kernel=None, overlap=False,
                attn_schedule=getattr(plan, "schedule", plan).describe())
    _plan_provenance(plan, prov, tracer)
    return exec_plan


def _dispatch_attn(ctx, q, k, v, resolved, causal, scale, q_positions,
                   kv_len, unfused):
    """Run one routed attention call from its memoized resolution. A shape
    with no plan, or one lowered to `unfused_attn`, runs the caller's
    `unfused` closure — the named degrade target, never a silent switch."""
    ctx.stats.executed_attn += 1
    if resolved is _FALLBACK or resolved.mode == "unfused_attn":
        return unfused()
    from repro_torch.core.attention import flat_attention
    return flat_attention(q, k, v, ctx.mesh, resolved, causal=causal,
                          scale=scale, q_positions=q_positions,
                          kv_len=kv_len)


def pattn(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *, unfused,
          causal: bool = True, tag: str = "", scale=None,
          q_positions=None, kv_len=None) -> torch.Tensor:
    """Plan-routed attention. q: (b, sq, h, d); k/v: (b, skv, hkv, d|dv) ->
    (b, sq, h, dv). `unfused` is the zero-arg reference path the call
    degrades to when routing is off or the lowering says fused is illegal."""
    ctx = shard_ctx.get_gemm_context()
    if ctx is None:
        return unfused()
    shape = _attn_shape(q, k, v, causal)
    key = (tag, shape)
    resolved = ctx.resolved.get(key)
    args = (causal, scale, q_positions, kv_len, unfused)
    if resolved is not None:
        if resolved is _UNROUTED:
            return unfused()
        return _dispatch_attn(ctx, q, k, v, resolved, *args)

    ctx.stats.record_attn(tag, shape)
    tracer = obs_trace.get_tracer()
    if ctx.mesh is None:
        ctx.stats.unrouted += 1
        ctx.resolved[key] = _UNROUTED
        if tracer is not None:
            tracer.instant(f"pattn.{tag or 'untagged'}", tag=tag,
                           shape=[shape.b, shape.sq, shape.skv, shape.h,
                                  shape.hkv, shape.d, shape.dv],
                           provenance="unrouted")
            tracer.metrics.counter("pattn.provenance.unrouted").inc()
        return unfused()
    if tracer is None:
        resolved = ctx.resolved[key] = _resolve_attn(ctx, shape, {}, None)
        return _dispatch_attn(ctx, q, k, v, resolved, *args)
    t0 = time.perf_counter()
    with tracer.span(f"pattn.{tag or 'untagged'}", cat=obs_trace.CAT_PMM,
                     tag=tag, shape=[shape.b, shape.sq, shape.skv, shape.h,
                                     shape.hkv, shape.d, shape.dv]) as prov:
        resolved = ctx.resolved[key] = _resolve_attn(ctx, shape, prov, tracer)
        out = _dispatch_attn(ctx, q, k, v, resolved, *args)
    dispatch_us = (time.perf_counter() - t0) * 1e6
    tracer.metrics.counter(f"pattn.provenance.{prov['provenance']}").inc()
    tracer.metrics.observe(
        f"pattn.dispatch_us.mode.{prov.get('mode', 'unfused_attn')}",
        dispatch_us)
    tracer.metrics.observe(
        f"pattn.dispatch_us.tag.{tag or 'untagged'}", dispatch_us)
    return out
