"""Traffic-replay serving harness: seeded request generation + a
virtual-clock continuous-batching loop over the real planner.

Port of `repro/launch/traffic.py`: the same generator, engine, charges and
sections, over the port's `deploy.batcher`, `deploy.planner` and
`obs.metrics`, so a seed gives the reference's trace request for request
and the same planner decisions give the same serving section.

A deterministic generator emits Poisson arrivals for multiple concurrent
tenants (each its own model config, all sharing one planner cache and one
engine), and the simulation loop replays them through the real serving
dispatch path: every admitted batch's GEMM workload
(`deploy.planner.model_workload` at the batch's M) is resolved through
`Planner.plan_cached` — exact hit, bucketed transfer, online analytic tune,
or fallback — exactly as `models.matmul.pmm` resolves a dispatch. Only the
*clock* is virtual: per-batch service time is the resolved plans'
predicted cost plus explicit, configurable charges for the things live
traffic pays when the shape stream fragments (per-new-shape first launch,
online-tune latency, transfer pricing, auto-fallback penalty). Everything
else — bucketing legality, transfer rejection on ragged M, analytic
shortlist pricing — is the production code deciding.

The admission policy under test is `deploy.batcher.ContinuousBatcher`:
bucket-aware admission keeps batched Ms on the warmed pow-2 pool; the
naive-FIFO baseline fragments. `launch/serve.py --traffic` replays a trace
against the live routed `pmm` path on the card (each distinct GEMM the
replay dispatches runs once through `mmad`) and embeds the serving section
in its run report.

SLO accounting: each request's deadline is `arrival + slo_ttft_s +
gen_len * slo_per_token_s` (from its tenant's spec). Goodput counts only
the tokens of requests that met their deadline; p50/p99 latency and TTFT
come from the run's `MetricsRegistry` histograms.
"""
from __future__ import annotations

import dataclasses
import math
import random
from typing import Callable, Dict, Iterable, List, Optional, Sequence, Tuple

from repro_torch.deploy.batcher import (Batch, BatchPolicy,
                                        ContinuousBatcher, Request,
                                        bucket_pool, decode_m)
from repro_torch.deploy.planner import model_workload
from repro_torch.obs.metrics import MetricsRegistry

PHASES = ("prefill", "decode")
PROVENANCES = ("hit", "bucketed", "analytic", "fallback")


# ---------------------------------------------------------------------------
# Trace generation
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class TenantSpec:
    """One tenant's arrival process + SLO contract."""
    name: str
    arch: str = "gemma-2b"            # registry arch backing this tenant
    rate_rps: float = 50.0            # Poisson arrival rate
    n_requests: int = 16
    prompt_lens: Tuple[int, ...] = (5, 9, 13, 17)
    gen_lens: Tuple[int, ...] = (2, 3, 5)
    start_s: float = 0.0
    slo_ttft_s: float = 0.5           # time-to-first-token budget
    slo_per_token_s: float = 0.1      # per-decode-token budget


@dataclasses.dataclass(frozen=True)
class TrafficConfig:
    """A reproducible traffic trace: seed + tenant specs."""
    seed: int = 0
    tenants: Tuple[TenantSpec, ...] = (TenantSpec(name="tenant0"),)

    def max_rows(self, policy: BatchPolicy) -> int:
        """Upper bound on any admitted batch's token rows under `policy`
        (prefill: max_batch largest prompts; decode: max_batch sequences) —
        what `warm_pool` sizes the warmed bucket ladder to."""
        top = max(max(t.prompt_lens) for t in self.tenants)
        return max(policy.max_batch * top, policy.max_batch)


def generate_trace(cfg: TrafficConfig) -> List[Request]:
    """The deterministic seeded trace: same config -> identical request list.

    Each tenant draws from its own `random.Random(f"{seed}:{name}")` stream
    (string seeding is sha512-based and platform-stable), so adding a tenant
    never perturbs another tenant's arrivals. Requests are merged by arrival
    time (ties broken by tenant declaration order) and assigned global rids
    in that order.
    """
    drawn = []
    for t_idx, spec in enumerate(cfg.tenants):
        rng = random.Random(f"{cfg.seed}:{spec.name}")
        now = spec.start_s
        slo = spec.slo_ttft_s
        for i in range(spec.n_requests):
            now += rng.expovariate(spec.rate_rps)
            prompt = rng.choice(spec.prompt_lens)
            gen = rng.choice(spec.gen_lens)
            drawn.append((now, t_idx, i, spec.name, prompt, gen,
                          slo + gen * spec.slo_per_token_s))
    drawn.sort(key=lambda r: (r[0], r[1], r[2]))
    return [Request(rid=rid, tenant=name, arrival_s=now, prompt_len=prompt,
                    gen_len=gen, slo_s=slo)
            for rid, (now, _, _, name, prompt, gen, slo) in enumerate(drawn)]


# ---------------------------------------------------------------------------
# Virtual-clock accounting
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class ServingCosts:
    """Virtual charges for the real prices of shape fragmentation.

    Plan-predicted execution time is the cost model's number; these cover
    the host-side work around it. All in virtual seconds, all deterministic.
    """
    # per-batch launch overhead (host dispatch of one engine step).
    step_overhead_s: float = 1e-4
    # charged ONCE per GEMM shape the engine has never executed: on the
    # card it stands for a shape's first launch (its plan lowered, its
    # launch geometry and tensor maps built); the warmed pool has paid it.
    # A virtual charge, kept at the reference's value for parity; it is
    # no measured time.
    compile_s: float = 0.05
    # charged when a shape first resolves via the online analytic tune.
    online_tune_s: float = 2e-3
    # charged when a shape first resolves via a bucketed transfer.
    transfer_s: float = 5e-4
    # a fallback (no plan) runs the auto dataflow: its time is the shape's
    # roofline floor times this penalty (an untuned collective placement).
    fallback_penalty: float = 3.0


@dataclasses.dataclass
class RequestRecord:
    """Per-request accounting the SLO summary is computed from."""
    rid: int
    tenant: str
    arrival_s: float
    prompt_len: int
    gen_len: int
    slo_s: float
    ttft_s: float = math.nan
    done_s: float = math.nan

    @property
    def tokens(self) -> int:
        return self.prompt_len + self.gen_len

    @property
    def latency_s(self) -> float:
        return self.done_s - self.arrival_s

    @property
    def met(self) -> bool:
        return self.latency_s <= self.slo_s


def slo_summary(records: Sequence[RequestRecord],
                makespan_s: float) -> Dict[str, float]:
    """Goodput/deadline arithmetic over completed request records.

    Goodput counts only the tokens (prompt + generated) of requests that
    finished within their SLO deadline; throughput counts everything.
    """
    met = [r for r in records if r.met]
    good = sum(r.tokens for r in met)
    total = sum(r.tokens for r in records)
    n = len(records)
    span = max(makespan_s, 1e-12)
    return {
        "requests": n,
        "met": len(met),
        "missed": n - len(met),
        "deadline_miss_rate": (n - len(met)) / n if n else 0.0,
        "good_tokens": good,
        "total_tokens": total,
        "goodput_tps": good / span,
        "throughput_tps": total / span,
    }


@dataclasses.dataclass
class ServingResult:
    """Everything one simulated replay measured."""
    policy: BatchPolicy
    records: List[RequestRecord]
    per_phase: Dict[str, Dict[str, int]]
    batches: int
    cold_shapes: int       # shapes that paid the virtual compile charge
    distinct_shapes: int   # distinct GEMM shapes the replay dispatched
    makespan_s: float
    metrics: MetricsRegistry

    @property
    def dispatches(self) -> int:
        return sum(sum(c.values()) for c in self.per_phase.values())

    @property
    def resolve_rate(self) -> float:
        n = self.dispatches
        resolved = n - sum(c["fallback"] for c in self.per_phase.values())
        return resolved / n if n else 0.0


def _phase_section(counts: Dict[str, int]) -> Dict[str, float]:
    total = sum(counts.values())
    resolved = total - counts["fallback"]
    return dict(counts,
                dispatches=total,
                hit_rate=counts["hit"] / total if total else 0.0,
                resolve_rate=resolved / total if total else 0.0)


def serving_section(result: ServingResult) -> Dict[str, object]:
    """The run report's `serving` section (and BENCH_serving's per-run
    record): SLO summary + tail latencies + admission/planner accounting.
    Field-by-field reference in docs/serving.md."""
    lat = result.metrics.histogram("serving.latency_s").to_dict()
    ttft = result.metrics.histogram("serving.ttft_s").to_dict()
    util = result.metrics.histogram("serving.batch_utilization").to_dict()
    out: Dict[str, object] = {"policy": result.policy.mode}
    out.update(slo_summary(result.records, result.makespan_s))
    out.update(
        p50_latency_s=lat["p50"], p99_latency_s=lat["p99"],
        p50_ttft_s=ttft["p50"], p99_ttft_s=ttft["p99"],
        makespan_s=result.makespan_s,
        batches=result.batches,
        cold_shapes=result.cold_shapes,
        distinct_shapes=result.distinct_shapes,
        mean_batch_utilization=util["mean"],
        resolve_rate=result.resolve_rate,
        per_phase={phase: _phase_section(counts)
                   for phase, counts in result.per_phase.items()},
    )
    return out


# ---------------------------------------------------------------------------
# Warm pool
# ---------------------------------------------------------------------------

def warm_pool(planner, cfgs: Dict[str, object], policy: BatchPolicy,
              max_rows: int) -> List[object]:
    """Batch-tune every GEMM shape the bucket policy can emit for `cfgs`'
    workloads up to `max_rows` token rows (prefill AND decode at each pow-2
    M of the bucket ladder). Returns the warmed shape list — the sim treats
    these as pre-compiled (`precompiled=` arg), mirroring a real server's
    startup warm-up."""
    shapes: List[object] = []
    for m in bucket_pool(max_rows, policy):
        for cfg in cfgs.values():
            shapes += model_workload(cfg, batch=m, seq=1, kind="prefill")
            shapes += model_workload(cfg, batch=m, seq=1, kind="decode")
    shapes = list(dict.fromkeys(shapes))
    planner.batch_tune(shapes)
    return shapes


# ---------------------------------------------------------------------------
# The virtual-clock replay loop
# ---------------------------------------------------------------------------

def _classify(plan) -> str:
    """Provenance class of a served plan — mirrors matmul.lookup_plan."""
    source = getattr(plan, "source", "")
    return source if source in ("bucketed", "analytic") else "hit"


def _auto_floor_s(shape, hw, elem_bytes: int) -> float:
    """Roofline floor for an unplanned (auto) GEMM on `hw`."""
    return max(shape.flops() / hw.peak_flops,
               shape.min_bytes(elem_bytes) / hw.hbm.total_bw)


class _Engine:
    """One serial engine: batched prefill + round-robin decode rounds."""

    def __init__(self, trace, planner, cfgs, policy, costs, precompiled,
                 dispatch):
        self.trace = sorted(trace, key=lambda r: (r.arrival_s, r.rid))
        self.planner = planner
        self.cfgs = cfgs
        self.policy = policy
        self.costs = costs
        self.dispatch = dispatch
        self.batcher = ContinuousBatcher(policy)
        self.seen = set(precompiled)   # shapes that paid (or pre-paid) compile
        self.executed = set()          # distinct shapes this replay dispatched
        self.cold_shapes = 0
        self.pools: Dict[str, List[List]] = {}    # tenant -> [[rec, left]..]
        self.order: List[str] = []                # decode round-robin order
        self.rr = 0
        self.records: Dict[int, RequestRecord] = {}
        self.per_phase = {p: {k: 0 for k in PROVENANCES} for p in PHASES}
        self.metrics = MetricsRegistry()
        self.batches = 0
        self.prefer = "prefill"
        self.now = 0.0
        self.idx = 0

    # -- work selection ------------------------------------------------------

    def _deliver(self) -> None:
        while self.idx < len(self.trace) \
                and self.trace[self.idx].arrival_s <= self.now:
            req = self.trace[self.idx]
            self.batcher.submit(req)
            self.records[req.rid] = RequestRecord(
                rid=req.rid, tenant=req.tenant, arrival_s=req.arrival_s,
                prompt_len=req.prompt_len, gen_len=req.gen_len,
                slo_s=req.slo_s)
            self.idx += 1

    def _decode_tenant(self) -> Optional[str]:
        live = [t for t in self.order if self.pools.get(t)]
        if not live:
            return None
        tenant = live[self.rr % len(live)]
        self.rr += 1
        return tenant

    def _next_batch(self) -> Optional[Batch]:
        phases = (("prefill", "decode") if self.prefer == "prefill"
                  else ("decode", "prefill"))
        for phase in phases:
            if phase == "prefill":
                batch = self.batcher.next_prefill(self.now)
                if batch is not None:
                    self.prefer = "decode"
                    return batch
            else:
                tenant = self._decode_tenant()
                if tenant is not None:
                    self.prefer = "prefill"
                    return self._decode_round(tenant)
        return None

    def _decode_round(self, tenant: str) -> Batch:
        pool = self.pools[tenant]
        served = pool[:self.policy.max_batch]
        reqs = tuple(entry[0] for entry in served)
        rows = len(served)
        return Batch(tenant=tenant, phase="decode", requests=reqs,
                     rows=rows, m=decode_m(rows, self.policy))

    # -- pricing -------------------------------------------------------------

    def _serve(self, batch: Batch) -> float:
        cfg = self.cfgs[batch.tenant]
        shapes = model_workload(cfg, batch=batch.m, seq=1, kind=batch.phase)
        dt = self.costs.step_overhead_s
        for shape in shapes:
            plan = self.planner.plan_cached(shape)
            prov = "fallback" if plan is None else _classify(plan)
            self.per_phase[batch.phase][prov] += 1
            if plan is None:
                dt += self.costs.fallback_penalty * _auto_floor_s(
                    shape, self.planner.hw, self.planner.elem_bytes)
            else:
                dt += plan.report.total_time
            if shape not in self.executed:
                # real-dispatch hook: once per distinct shape, warmed or
                # not (the reference's trace-time semantics)
                self.executed.add(shape)
                if self.dispatch is not None:
                    self.dispatch(shape, batch.phase)
            if shape not in self.seen:
                self.seen.add(shape)
                self.cold_shapes += 1
                dt += self.costs.compile_s
                if prov == "analytic":
                    dt += self.costs.online_tune_s
                elif prov == "bucketed":
                    dt += self.costs.transfer_s
        self.metrics.observe("serving.batch_utilization", batch.utilization)
        self.metrics.observe(f"serving.batch_service_s.{batch.phase}", dt)
        self.batches += 1
        return dt

    # -- completions ---------------------------------------------------------

    def _finish(self, batch: Batch, done: float) -> None:
        if batch.phase == "prefill":
            for req in batch.requests:
                rec = self.records[req.rid]
                rec.ttft_s = done - req.arrival_s
                self.metrics.observe("serving.ttft_s", rec.ttft_s)
                if req.gen_len == 0:
                    self._complete(rec, done)
                    continue
                if req.tenant not in self.pools:
                    self.pools[req.tenant] = []
                    self.order.append(req.tenant)
                self.pools[req.tenant].append([req, req.gen_len])
            return
        pool = self.pools[batch.tenant]
        served, rest = pool[:len(batch.requests)], pool[len(batch.requests):]
        alive = []
        for entry in served:
            entry[1] -= 1
            if entry[1] <= 0:
                self._complete(self.records[entry[0].rid], done)
            else:
                alive.append(entry)
        # survivors rotate to the tail so an over-full pool round-robins
        self.pools[batch.tenant] = rest + alive

    def _complete(self, rec: RequestRecord, done: float) -> None:
        rec.done_s = done
        self.metrics.observe("serving.latency_s", rec.latency_s)

    # -- the loop ------------------------------------------------------------

    def run(self) -> ServingResult:
        while True:
            self._deliver()
            batch = self._next_batch()
            if batch is None:
                horizons = []
                if self.idx < len(self.trace):
                    horizons.append(self.trace[self.idx].arrival_s)
                decision = self.batcher.next_decision_s()
                if decision is not None:
                    horizons.append(decision)
                if not horizons:
                    break                      # drained: no work anywhere
                self.now = max(self.now, min(horizons))
                continue
            self.now += self._serve(batch)
            self._finish(batch, self.now)
        assert len(self.records) == len(self.trace)
        assert all(math.isfinite(r.done_s) for r in self.records.values()), \
            "requests lost by the batching loop"
        return ServingResult(
            policy=self.policy,
            records=[self.records[r.rid] for r in self.trace],
            per_phase=self.per_phase, batches=self.batches,
            cold_shapes=self.cold_shapes,
            distinct_shapes=len(self.executed), makespan_s=self.now,
            metrics=self.metrics)


def simulate(trace: Sequence[Request], planner, cfgs: Dict[str, object],
             policy: BatchPolicy = BatchPolicy(),
             costs: ServingCosts = ServingCosts(),
             precompiled: Iterable = (),
             dispatch: Optional[Callable] = None) -> ServingResult:
    """Replay `trace` through the continuous batcher against `planner`.

    `cfgs` maps tenant name -> model config (duck-typed, jax-free).
    `precompiled` seeds the engine's seen-shape set (the warmed pool — those
    shapes never pay the virtual compile charge). `dispatch(shape, phase)`,
    when given, is invoked once per distinct shape — `serve --traffic` uses
    it to run the real routed `pmm` on the card (the reference's trace-time
    semantics: one real execution per distinct shape).
    """
    return _Engine(trace, planner, cfgs, policy, costs, precompiled,
                   dispatch).run()
