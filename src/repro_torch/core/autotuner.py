"""Schedule autotuner (paper §4.1.4: 'we iterate through our predefined
schedule candidates, guided by the insights above, to automatically select the
kernel achieving the best performance').

Candidate enumeration walks the deployment-schedule space:
  dataflow pattern x logical grid (gm, gn, gk) [cluster remap + 3-D split-K]
  x K-chunk tk x double-buffering x store stages x data layouts,
pruned by legality (divisibility, L1 capacity) and by the paper's insights
(Insight 2: prefer multicast; Insight 3: 3-D tiling for irregular shapes;
Insight 4: remap for flat GEMM). Each candidate is built into a BSP program
and priced with the SoftHier performance model; the best schedule wins.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Iterator, List, Optional, Tuple

from repro_torch.core.schedule import (GEMMShape, Schedule, Tiling, build_program,
                                 default_elem_dtype, inner_kernel_candidates)
from repro_torch.hw.config import AcceleratorConfig
from repro_torch.sim.calibrate import is_trusted as _trusted
from repro_torch.sim.calibrate import ranking_cost
from repro_torch.sim.perf import PerfReport, estimate, estimate_sweep

# The paper's search space (§4.1.4). The hierarchical compositions join it
# ONLY under a trusted (fit_ok) measured calibration — their simulated win
# must be backed by the machine before the default search may pick them
# (ROADMAP: "enumerate the hierarchical compositions in the DEFAULT tuner
# search space once the cost model is validated against measurements").
DEFAULT_DATAFLOWS = ("summa", "splitk_summa", "systolic", "baseline")
CALIBRATED_DATAFLOWS = ("systolic_over_summa", "summa_over_systolic")


def default_dataflows(calibration=None) -> List[str]:
    """The DEFAULT search space, widened by a trusted calibration profile."""
    out = list(DEFAULT_DATAFLOWS)
    if _trusted(calibration):
        out += list(CALIBRATED_DATAFLOWS)
    return out


# insight-score priority weight per dataflow (multiplied into the negated
# utilization proxy below; smaller weight = enumerated/priced later). Shared
# with the closed-form generator (core/analytic.py) so the two candidate
# sources rank by the same prior.
DATAFLOW_WEIGHT = {"summa": 1.0, "splitk_summa": 0.98, "systolic": 0.9,
                   "systolic_over_summa": 0.92, "summa_over_systolic": 0.9,
                   "baseline": 0.1}


@dataclasses.dataclass
class TunedResult:
    schedule: Schedule
    report: PerfReport
    candidates_tried: int
    # (describe, ranking_cost, utilization) per candidate tried — the cost
    # is the calibrated prediction when a trusted profile ranked the
    # search, NOT always analytical seconds (check `calibration` below).
    log: List[Tuple[str, float, float]]
    # digest of the trusted CalibrationProfile that ranked the candidates
    # ("" = ranked by the raw analytical prior).
    calibration: str = ""


def _pow2_range(lo: int, hi: int) -> List[int]:
    out = []
    v = lo
    while v <= hi:
        out.append(v)
        v *= 2
    return out


def _engine_friendly(tn: int, hw: AcceleratorConfig) -> float:
    """Fraction of engine columns busy for an N-tile of size tn (alignment)."""
    cc = hw.tile.ce_cols
    return tn / (math.ceil(tn / cc) * cc)


def insight_base(tm: int, tn: int, tk_eff: int,
                 hw: AcceleratorConfig) -> float:
    """Dataflow-independent part of the insight score: predicted engine
    utilization = M/N alignment x K-pipeline ceiling TK/(TK+fill), negated
    so lower = better. Split out so callers scoring one tile geometry
    under several dataflows (core/analytic.py) pay for it once."""
    fill = hw.tile.ce_rows + hw.tile.ce_cols
    eff_m = tm / (math.ceil(tm / hw.tile.ce_rows) * hw.tile.ce_rows)
    ceil_k = tk_eff / (tk_eff + fill)
    return -(_engine_friendly(tn, hw) * eff_m * ceil_k)


def insight_score(tm: int, tn: int, tk_eff: int, df: str,
                  hw: AcceleratorConfig) -> float:
    """Insight-based candidate priority (lower = better): `insight_base`
    weighted by the dataflow prior. The closed-form generator
    (core/analytic.py) ranks its shortlist by the same score, so the two
    candidate sources agree on what 'promising' means."""
    return insight_base(tm, tn, tk_eff, hw) * DATAFLOW_WEIGHT[df]


def enumerate_candidates(shape: GEMMShape, hw: AcceleratorConfig,
                         dataflows: Optional[List[str]] = None,
                         elem_bytes: int = 1,
                         max_candidates: int = 256,
                         calibration=None) -> Iterator[Schedule]:
    """Legal schedule candidates, insight-ordered (most promising first).

    The default dataflow set matches the paper's search space; passing
    `dataflows` explicitly widens or narrows it — including the
    hierarchical compositions (`systolic_over_summa` / `summa_over_systolic`,
    enumerated with the paper's (2, 2) inner group), which restricted
    searches (e.g. `dryrun --route-dataflows`) use to force Fig. 6c/6d
    schedules into the plan cache. A trusted (fit_ok) `calibration` profile
    widens the DEFAULT set with both hierarchical compositions — measured
    validation is the admission ticket.
    """
    rows, cols = hw.grid
    n_tiles = rows * cols
    dataflows = dataflows or default_dataflows(calibration)

    cands: List[Tuple[float, Schedule]] = []
    # the tk >= k_local clamp makes distinct tk values collapse onto the same
    # effective tiling; dedupe so max_candidates isn't spent on repeats.
    seen: set = set()
    # logical grids: gm * gn * gk == n_tiles, all powers of two.
    for gk in _pow2_range(1, n_tiles):
        rest = n_tiles // gk
        if rest * gk != n_tiles:
            continue
        for gm in _pow2_range(1, rest):
            gn = rest // gm
            if gm * gn != rest:
                continue
            # macro-iteration factors keep per-tile tiles engine-sized
            for iter_m in (1, 2, 4):
                for iter_n in (1, 2, 4):
                    if shape.m % (gm * iter_m) or shape.n % (gn * iter_n) or shape.k % gk:
                        continue
                    tm = shape.m // (gm * iter_m)
                    tn = shape.n // (gn * iter_n)
                    k_local = shape.k // gk
                    if tm == 0 or tn == 0 or k_local == 0:
                        continue
                    for tk in (64, 128, 256, 512):
                        if k_local % tk and k_local > tk:
                            continue
                        tk_eff = min(tk, k_local)
                        # L1 feasibility pre-check: double-buffered A/B + fp32 C
                        l1 = (2 * (tm * tk_eff + tk_eff * tn) * elem_bytes
                              + tm * tn * 4)
                        acc_bytes = 4
                        if l1 > hw.tile.l1_bytes:
                            # retry with fp16 accumulation (Insight-3 flat cases)
                            l1 = (2 * (tm * tk_eff + tk_eff * tn) * elem_bytes
                                  + tm * tn * 2)
                            acc_bytes = 2
                            if l1 > hw.tile.l1_bytes:
                                continue
                        for df in dataflows:
                            if df != "splitk_summa" and gk != 1:
                                continue
                            if df == "splitk_summa" and gk < 2:
                                continue
                            if df == "systolic" and (gm == 1 or gn == 1):
                                continue
                            if df in ("systolic_over_summa",
                                      "summa_over_systolic") \
                                    and (gm % 2 or gn % 2
                                         or (shape.k // tk_eff) % 2):
                                # hierarchical candidates use the paper's
                                # square (2, 2) inner group, which must
                                # divide the logical grid AND the K-step
                                # count (every such candidate previously
                                # died at build time during pricing)
                                continue
                            # insight-based priority scoring (lower =
                            # better) — iteration 8 of §Perf: the K-pipeline
                            # ceiling term is what surfaces deep-TK
                            # schedules that tile-size-only scoring missed.
                            score = insight_score(tm, tn, tk_eff, df, hw)
                            key = (gm, gn, gk, iter_m, iter_n, tk_eff, df,
                                   acc_bytes)
                            if key in seen:
                                continue
                            seen.add(key)
                            cands.append((score, Schedule(
                                shape=shape,
                                tiling=Tiling(gm, gn, gk, iter_m, iter_n, tk_eff),
                                dataflow=df, inner=(2, 2),
                                elem_bytes=elem_bytes,
                                acc_bytes=acc_bytes,
                                elem_dtype=default_elem_dtype(elem_bytes, hw))))
    cands.sort(key=lambda sc: sc[0])
    for _, sched in cands[:max_candidates]:
        yield sched


def price_candidates(candidates: Iterator[Schedule], hw: AcceleratorConfig,
                     store_stage_options: Tuple[int, ...] = (1, 4),
                     calibration=None,
                     inner_kernels="auto"
                     ) -> Tuple[Optional[Tuple[float, Schedule, PerfReport]],
                                List[Tuple[str, float, float]], int]:
    """The shared pricing loop behind `tune` and `analytic.analytic_tune`:
    build each candidate into a BSP program (sweeping store stages) and
    price it with the SoftHier model, ranked by the calibration-aware cost.
    Returns (best, log, tried) where best is (cost, schedule, report) — or
    None when no candidate built legally.

    `inner_kernels` makes the intra-device level part of the same search:

    - `"auto"` (default): each outer candidate is joint-priced against its
      closed-form `inner_kernel_candidates` shortlist PLUS the bare
      `None` (XLA-picks) path. A schedule arriving with an explicit
      `inner_kernel` is priced only under it (the caller already chose).
    - `None`: legacy single-level pricing — every candidate keeps
      `inner_kernel=None`.
    - a tuple of `InnerKernel`s (or `None`s): the explicit sweep set.

    Inner candidates are swept BEFORE `None` and the best is kept by strict
    `<`, so when a planner-visible kernel prices exactly like the opaque
    path (the aligned-geometry tie the cost model constructs on purpose)
    the plan carries real, reportable geometry. Communication pricing runs
    once per program (`estimate_sweep`), so the joint search costs one comm
    pass plus a cheap compute recombination per inner candidate.
    """
    cost = ranking_cost(calibration)
    best: Optional[Tuple[float, Schedule, PerfReport]] = None
    log: List[Tuple[str, float, float]] = []
    tried = 0
    for base in candidates:
        for stages in store_stage_options:
            sched = dataclasses.replace(base, store_stages=stages)
            try:
                prog = build_program(sched, hw)
            except (ValueError, KeyError):
                continue
            if sched.inner_kernel is not None:
                inners = (sched.inner_kernel,)
            elif inner_kernels == "auto":
                inners = inner_kernel_candidates(sched, hw) + (None,)
            elif inner_kernels is None:
                inners = (None,)
            else:
                inners = tuple(inner_kernels)
            for ik, rep in estimate_sweep(prog, hw, inners):
                cand = (sched if ik is sched.inner_kernel
                        else dataclasses.replace(sched, inner_kernel=ik))
                tried += 1
                log.append((cand.describe(), cost(rep), rep.utilization(hw)))
                if best is None or cost(rep) < best[0]:
                    best = (cost(rep), cand, rep)
    return best, log, tried


def tune(shape: GEMMShape, hw: AcceleratorConfig,
         dataflows: Optional[List[str]] = None,
         elem_bytes: int = 1,
         max_candidates: int = 48,
         store_stage_options: Tuple[int, ...] = (1, 4),
         calibration=None) -> TunedResult:
    """Build + price candidates; return the fastest schedule.

    With a trusted `calibration` profile, candidates are ranked by the
    calibrated cost (`profile.predict` over the analytical report) — the
    measured per-resource scale factors decide the winner, not the raw
    prior. The winning plan's report stays analytical (the fleet-wide
    comparable number); the ranking provenance is in
    `TunedResult.calibration`.
    """
    best, log, tried = price_candidates(
        enumerate_candidates(shape, hw, dataflows, elem_bytes,
                             max_candidates=max_candidates,
                             calibration=calibration),
        hw, store_stage_options, calibration)
    if best is None:
        raise RuntimeError(f"no legal schedule found for {shape} on {hw.name}")
    return TunedResult(schedule=best[1], report=best[2],
                       candidates_tried=tried, log=log,
                       calibration=calibration.digest()
                       if _trusted(calibration) else "")


def tune_cached(shape: GEMMShape, hw: AcceleratorConfig,
                cache, **tune_kwargs) -> TunedResult:
    """Cache-aware `tune`: consult a `repro_torch.deploy.PlanCache` first.

    A hit returns immediately with candidates_tried == 0 (no enumeration, no
    pricing); a miss runs the normal search and persists the winner. This is
    the minimal entry point for callers that don't want a full
    `repro_torch.deploy.Planner` (which adds shape bucketing and refinement).

    A `dataflows` restriction keys its plans under a separate cache variant,
    so constrained searches never collide with (or clobber) the unrestricted
    winners. Other knobs (max_candidates, store_stage_options) affect search
    effort, not validity, so a hit tuned under different effort is served —
    but a hit ranked under a different calibration regime (see
    `repro_torch.deploy.Planner._admissible`) is NOT: it gets re-tuned and
    replaced, so a trusted profile never becomes a silent no-op against a
    previously warmed cache.
    """
    from repro_torch.deploy.plan import (plan_admissible,   # deploy imports us
                                   plan_from_tuning, search_variant)

    elem_bytes = tune_kwargs.get("elem_bytes", 1)
    # [] means 'unrestricted' to enumerate_candidates; keep the cache
    # variant and the admissibility check consistent with that.
    dataflows = tune_kwargs.get("dataflows") or None
    calibration = tune_kwargs.get("calibration")
    regime = calibration.digest() if _trusted(calibration) else ""
    variant = search_variant(dataflows)
    plan = cache.get(shape, elem_bytes, hw, variant)
    if plan is not None and not plan_admissible(plan, dataflows, regime):
        plan = None      # wrong dataflow space or calibration regime
    if plan is not None:
        return TunedResult(schedule=plan.schedule, report=plan.report,
                           candidates_tried=0, log=[],
                           calibration=plan.calibration_digest)
    res = tune(shape, hw, **tune_kwargs)
    cache.put(plan_from_tuning(shape, hw, res.schedule, res.report,
                               candidates_tried=res.candidates_tried,
                               variant=variant,
                               calibration_digest=res.calibration))
    return res
