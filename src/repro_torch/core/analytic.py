"""Closed-form candidate shortlist: GOMA-style analytical-first tuning.

`autotuner.enumerate_candidates` walks the whole deployment-schedule space
and relies on pricing hundreds of candidates to find the winner — fine for
warm-up, unaffordable on a serving miss. GOMA (PAPERS.md) shows that
near-optimal GEMM mappings can be *derived* from the cost model's geometry
in microseconds instead of searched for. This module does that derivation
against the SoftHier model's resource-balance structure:

- **split-K depth** (paper Insight 3): a 2-D output grid keeps at most
  (M/ce_rows) x (N/ce_cols) engine-aligned output tiles busy. When that is
  fewer than the mesh's tiles the GEMM is flat and the idle tiles should
  take K-slices instead: the ideal depth is gk* = n_tiles / out_tiles,
  snapped to the legal power-of-two divisors, with its log-space
  neighbours (and gk = 1) kept as hedges.
- **grid aspect** (NoC/DMA balance): per superstep a (gm x gn) grid moves
  A-panels of tm*tk and B-panels of tk*tn bytes; their sum is minimized at
  gm* = sqrt(rest * M / N). The engine-alignment variant
  sqrt(rest * (M/ce_rows) / (N/ce_cols)) corrects for the asymmetric MAC
  array. The nearest legal power-of-two grids to either ideal are kept.
- **tile residency** (L1 fit): per grid, the largest K-chunk from the
  tuner's tk menu that divides K_local and fits double-buffered A/B panels
  plus the accumulator in L1 (with the fp16-accumulator fallback for flat
  cases), at the smallest macro-iteration factors that make the tiling
  divide the shape — more iterations only add supersteps and barriers
  under BSP max semantics, so the minimum feasible pair dominates.
- **dataflow choice**: split-K grids lower through `splitk_summa`;
  2-D grids enumerate `summa` / `systolic` (and the hierarchical
  compositions when the search space admits them — same trusted-
  calibration gate as the exhaustive tuner), ranked by the shared
  insight score so NoC-heavy patterns only lead where their multicast
  share pays.

`analytic_shortlist` returns the top-k Schedules of that construction
(sub-millisecond mean, no program builds); `analytic_tune` prices them
exactly like
`tune` does (same `price_candidates` loop, store-stage sweep,
calibration-aware ranking) — bounded work per plan-cache miss.
`agreement_stats` is the gate: rank agreement of the shortlist against
exhaustive search over a shape grid, exported as BENCH_analytic.json and
asserted in CI (see docs/benchmarking.md).
"""
from __future__ import annotations

import math
import time
from typing import Dict, List, Optional, Sequence, Tuple

from repro_torch.core.autotuner import (DATAFLOW_WEIGHT, TunedResult,
                                  default_dataflows, enumerate_candidates,
                                  insight_base, price_candidates, tune)
from repro_torch.core.schedule import (GEMMShape, Schedule, Tiling,
                                 default_elem_dtype)
from repro_torch.hw.config import AcceleratorConfig
from repro_torch.sim.calibrate import is_trusted as _trusted
from repro_torch.sim.calibrate import ranking_cost

# shortlist width: wide enough that the generator's 2-3 hedges per decision
# (split-K depths x grid aspects x tile variants) survive the cap, narrow
# enough that online pricing stays O(10) program builds.
DEFAULT_SHORTLIST_K = 32

# candidate families (split-K depth, grid, K-chunk) kept per shape: the cap
# guarantees the round-robin reaches the iteration/accumulator hedges of
# the strong families instead of spreading one-deep over every weak one.
_MAX_FAMILIES = 12

# relative band within which two priced candidates count as the same rank:
# the schedule space holds near-degenerate optima, and argmin among them is
# enumeration-order noise (mirrors the spirit of calibrate.py's
# picks_ratio <= 1 + eps trust gate).
TOP1_TIE_RTOL = 1e-3

# the tuner's K-chunk menu, largest first (larger tk = fewer pipeline fills
# and fewer supersteps, bounded by L1 residency).
_TK_MENU = (512, 256, 128, 64)

# macro-iteration factors ordered by total superstep multiplier — the first
# feasible pair wins (see module docstring).
_ITER_OPTIONS = tuple(sorted(((im, it) for im in (1, 2, 4)
                              for it in (1, 2, 4)),
                             key=lambda p: (p[0] * p[1], p)))


def _pow2_divisors(n: int) -> List[int]:
    out, v = [], 1
    while v <= n and n % v == 0:
        out.append(v)
        v *= 2
    return out


def _log2_dist(a: float, b: float) -> float:
    return abs(math.log2(max(a, 1e-12)) - math.log2(max(b, 1e-12)))


def _acc_bytes_for(tm: int, tn: int, tk_eff: int, elem_bytes: int,
                   l1_bytes: int) -> Optional[int]:
    """L1 feasibility: double-buffered A/B panels + accumulator, fp32 with
    the fp16 fallback (the same rule `enumerate_candidates` prunes by)."""
    for acc in (4, 2):
        if 2 * (tm * tk_eff + tk_eff * tn) * elem_bytes + tm * tn * acc \
                <= l1_bytes:
            return acc
    return None


def _split_k_depths(shape: GEMMShape, hw: AcceleratorConfig,
                    n_tiles: int) -> List[int]:
    """Candidate split-K depths from two closed-form signals.

    Output parallelism (Insight 3's flat-GEMM regime):
    gk* = n_tiles / ((M/ce_rows) * (N/ce_cols)) is where the 2-D grid runs
    out of engine-aligned output tiles and idle tiles should take K-slices.

    K vs tile arithmetic intensity: when K dwarfs the output dims, split-K
    trades the per-superstep NoC panel traffic for one partial-sum
    reduction — the sweet spot leaves each tile a K-slice of a handful of
    max-size engine chunks, gk = K / (tk_max * c) for small c.

    Each target is snapped to the nearest (log-space) legal power-of-two
    divisor of both the mesh and K; gk = 1 is always kept as the hedge.
    """
    legal = sorted(g for g in _pow2_divisors(n_tiles) if shape.k % g == 0)
    if not legal:
        return [1]
    out_tiles = max((shape.m / hw.tile.ce_rows)
                    * (shape.n / hw.tile.ce_cols), 1e-12)
    ideal = min(max(n_tiles / out_tiles, 1.0), float(n_tiles))
    target = 1 << max(0, round(math.log2(ideal)))
    targets = {1, max(1, target // 2), target, min(n_tiles, target * 2)}
    for chunks in (1, 2, 4):
        depth = shape.k / (_TK_MENU[0] * chunks)
        if depth >= 2:
            targets.add(1 << round(math.log2(depth)))
    picks = {min(legal, key=lambda g: (_log2_dist(g, t), g))
             for t in targets}
    return sorted(picks)


def _grid_aspects(shape: GEMMShape, hw: AcceleratorConfig, rest: int,
                  keep: int) -> List[int]:
    """The `keep` legal gm values nearest (in log space) to either ideal —
    the NoC/DMA-balance aspect sqrt(rest*M/N) (minimizes the A+B panel
    bytes each superstep moves) or its engine-aligned correction
    sqrt(rest * (M/ce_rows) / (N/ce_cols)) — plus the legal extremes
    (gm = 1 and gm = rest): a degenerate grid drops one multicast
    direction entirely, the NoC-minimizing corner a NoC-expensive
    calibration can prefer over any balanced aspect."""
    opts = [gm for gm in _pow2_divisors(rest)
            if shape.m % gm == 0 and shape.n % (rest // gm) == 0]
    if not opts:
        return []
    ideal_noc = math.sqrt(rest * shape.m / shape.n)
    ideal_eng = math.sqrt(rest * (shape.m / hw.tile.ce_rows)
                          / max(shape.n / hw.tile.ce_cols, 1e-12))

    def dist(gm: int) -> float:
        return min(_log2_dist(gm, ideal_noc), _log2_dist(gm, ideal_eng))

    picks = set(sorted(opts, key=lambda gm: (dist(gm), gm))[:keep])
    picks.update((opts[0], opts[-1]))
    return sorted(picks)


def _tile_variants(shape: GEMMShape, hw: AcceleratorConfig, gm: int, gn: int,
                   gk: int, elem_bytes: int, n_tk: int = 3
                   ) -> List[Tuple[int, int, int, int]]:
    """(iter_m, iter_n, tk_eff, acc_bytes) picks for one logical grid: the
    `n_tk` largest feasible K-chunks, each with up to three macro-iteration
    pairs — the smallest that divides the shape and fits L1 (fewest
    supersteps wins under BSP max semantics), the smallest that regains
    the fp32 accumulator when the minimum only fits fp16, and the next
    pair up as the panel-halving hedge (under a NoC-expensive calibration
    smaller multicast panels can out-price the extra supersteps)."""
    k_local = shape.k // gk
    out: List[Tuple[int, int, int, int]] = []
    seen_tk = set()
    l1 = hw.tile.l1_bytes
    db2 = 2 * elem_bytes
    # (im, it, tm+tn, tm*tn) for every pair that divides the shape — the
    # L1 check below is db2*tk*(tm+tn) + acc*tm*tn <= l1 (same rule as
    # `_acc_bytes_for`, inlined: this loop is the generation hot path).
    divisible = [(im, it,
                  shape.m // (gm * im) + shape.n // (gn * it),
                  (shape.m // (gm * im)) * (shape.n // (gn * it)))
                 for im, it in _ITER_OPTIONS
                 if not (shape.m % (gm * im) or shape.n % (gn * it))
                 and shape.m // (gm * im) and shape.n // (gn * it)]
    for tk in _TK_MENU:
        if k_local % tk and k_local > tk:
            continue
        tk_eff = min(tk, k_local)
        if tk_eff in seen_tk:
            continue
        panels = db2 * tk_eff
        feasible = [(im, it, 4 if panels * s + 4 * p <= l1 else 2)
                    for im, it, s, p in divisible
                    if panels * s + 2 * p <= l1]
        if not feasible:
            continue
        picks = [0]
        if feasible[0][2] == 2:
            fp32 = next((i for i, f in enumerate(feasible) if f[2] == 4),
                        None)
            if fp32 is not None:
                picks.append(fp32)
        nxt = max(picks) + 1
        if nxt < len(feasible):
            picks.append(nxt)
        # deep panel-halving hedge: the first pair that quarters a panel
        # dim — the far end of the supersteps-vs-panel-bytes trade.
        deep = next((i for i, f in enumerate(feasible)
                     if max(f[0], f[1]) >= 4), None)
        if deep is not None and deep not in picks:
            picks.append(deep)
        for i in sorted(set(picks)):
            im, it, acc = feasible[i]
            out.append((im, it, tk_eff, acc))
        seen_tk.add(tk_eff)
        if len(seen_tk) >= n_tk:
            break
    return out


def analytic_shortlist(shape: GEMMShape, hw: AcceleratorConfig,
                       k: int = DEFAULT_SHORTLIST_K,
                       elem_bytes: int = 1,
                       dataflows: Optional[List[str]] = None,
                       calibration=None) -> List[Schedule]:
    """Top-k closed-form Schedule shortlist for `shape` on `hw`.

    Deterministic, deduplicated, and a strict subset of the exhaustive
    candidate space (same legality rules), ranked by the shared insight
    score. The k-cap is *stratified* over (split-K depth, grid) families —
    round-robin by per-family score order — so every geometric hedge keeps
    representation; a greedy global top-k would let the prior silently
    drop whole families, which is exactly the mistake pricing exists to
    catch. The dataflow space matches `tune`'s: `dataflows` restricts it,
    and a trusted `calibration` widens the default set with the
    hierarchical compositions.
    """
    rows, cols = hw.grid
    n_tiles = rows * cols
    allowed = list(dataflows or default_dataflows(calibration))
    # family key (gk, gm, tk_eff) -> [(score, cand_key)]; Schedules
    # materialize only for the survivors (construction is the expensive
    # part). tk is part of the family key on purpose: the insight score's
    # pipeline-ceiling term systematically prefers large chunks, and a
    # global ranking would starve the small-tk hedges the DMA-bound regime
    # occasionally needs.
    families: Dict[Tuple[int, int, int], List[Tuple[float, tuple]]] = {}
    seen = set()
    base_cache: Dict[Tuple[int, int, int], float] = {}

    for gk in _split_k_depths(shape, hw, n_tiles):
        rest = n_tiles // gk
        # the exhaustive tuner's dataflow/grid compatibility rules
        dfs = [df for df in allowed if (df == "splitk_summa") == (gk > 1)]
        if not dfs:
            continue
        grids = _grid_aspects(shape, hw, rest, keep=3 if gk == 1 else 2)
        for rank, gm in enumerate(grids):
            gn = rest // gm
            for im, it, tk_eff, acc in _tile_variants(shape, hw, gm, gn, gk,
                                                      elem_bytes):
                tm, tn = shape.m // (gm * im), shape.n // (gn * it)
                base = base_cache.get((tm, tn, tk_eff))
                if base is None:
                    base = insight_base(tm, tn, tk_eff, hw)
                    base_cache[(tm, tn, tk_eff)] = base
                for df in dfs:
                    if df == "systolic" and (gm == 1 or gn == 1):
                        continue
                    if df in ("systolic_over_summa", "summa_over_systolic") \
                            and (gm % 2 or gn % 2
                                 or (shape.k // gk // tk_eff) % 2):
                        # the (2, 2) inner group must divide the logical
                        # grid AND the K-step count (each outer step
                        # consumes `inner` tk-chunks)
                        continue
                    if df == "baseline" and rank > 0:
                        # baseline is a hedge, not a contender — one grid
                        continue
                    key = (gm, gn, gk, im, it, tk_eff, df, acc)
                    if key in seen:
                        continue
                    seen.add(key)
                    families.setdefault((gk, gm, tk_eff), []).append(
                        (base * DATAFLOW_WEIGHT[df], key))

    ordered = sorted(families.values(),
                     key=lambda f: min(rec[0] for rec in f))[:_MAX_FAMILIES]
    for fam in ordered:
        fam.sort(key=lambda rec: (rec[0], rec[1]))
    picked: List[tuple] = []
    depth = 0
    while len(picked) < k and any(depth < len(f) for f in ordered):
        for fam in ordered:
            if depth < len(fam) and len(picked) < k:
                picked.append(fam[depth][1])
        depth += 1

    elem_dtype = default_elem_dtype(elem_bytes, hw)
    short = [Schedule(shape=shape,
                      tiling=Tiling(gm, gn, gk, im, it, tk_eff),
                      dataflow=df, inner=(2, 2), elem_bytes=elem_bytes,
                      acc_bytes=acc, elem_dtype=elem_dtype)
             for gm, gn, gk, im, it, tk_eff, df, acc in picked]
    if not short:
        # geometry found nothing (degenerate divisibility) — fall back to
        # the head of the exhaustive enumeration so the analytic path never
        # fails where the full search would have succeeded.
        short = list(enumerate_candidates(shape, hw, dataflows, elem_bytes,
                                          max_candidates=k,
                                          calibration=calibration))
    return short


def analytic_tune(shape: GEMMShape, hw: AcceleratorConfig,
                  dataflows: Optional[List[str]] = None,
                  elem_bytes: int = 1,
                  k: int = DEFAULT_SHORTLIST_K,
                  store_stage_options: Tuple[int, ...] = (1, 4),
                  calibration=None) -> TunedResult:
    """Price the closed-form shortlist; return the fastest schedule.

    The online-serving counterpart of `autotuner.tune`: identical pricing
    (BSP build + SoftHier estimate, store-stage sweep, calibration-aware
    ranking) over the O(k) shortlist instead of the full enumeration —
    bounded work per plan-cache miss.
    """
    short = analytic_shortlist(shape, hw, k=k, elem_bytes=elem_bytes,
                               dataflows=dataflows, calibration=calibration)
    best, log, tried = price_candidates(iter(short), hw, store_stage_options,
                                        calibration)
    if best is None:
        raise RuntimeError(
            f"no legal analytic candidate for {shape} on {hw.name}")
    return TunedResult(schedule=best[1], report=best[2],
                       candidates_tried=tried, log=log,
                       calibration=calibration.digest()
                       if _trusted(calibration) else "")


# ---------------------------------------------------------------------------
# The gate: rank agreement against exhaustive search
# ---------------------------------------------------------------------------

def agreement_stats(shapes: Sequence[GEMMShape], hw: AcceleratorConfig,
                    k: int = DEFAULT_SHORTLIST_K,
                    elem_bytes: int = 1,
                    dataflows: Optional[List[str]] = None,
                    calibration=None,
                    max_exhaustive: int = 1024,
                    store_stage_options: Tuple[int, ...] = (1, 4)
                    ) -> Dict[str, object]:
    """Rank-agreement harness: shortlist-best vs exhaustive-best per shape.

    The objective is the same `ranking_cost` both tuners minimize (the
    calibrated prediction under a trusted profile, else analytical
    seconds). `top1` means the shortlist's priced best matches — or beats,
    when `max_exhaustive` truncates the full space — the exhaustive
    optimum's cost within `TOP1_TIE_RTOL`: the candidate space holds
    near-degenerate optima (distinct schedules pricing within a fraction
    of a permille), and which one argmin lands on there is enumeration-
    order noise, not a rank disagreement. `cost_ratio` is shortlist-best /
    exhaustive-best, with no band. This is the gate BENCH_analytic.json
    exports and CI asserts on.
    """
    cost = ranking_cost(calibration)
    per_shape: List[Dict[str, object]] = []
    for shape in shapes:
        # best-of-2: generation is deterministic and pure, and the first
        # call after a multi-second exhaustive tune pays cold caches that
        # say nothing about steady-state shortlist latency.
        gen_us = float("inf")
        for _ in range(2):
            t0 = time.perf_counter()
            short = analytic_shortlist(shape, hw, k=k,
                                       elem_bytes=elem_bytes,
                                       dataflows=dataflows,
                                       calibration=calibration)
            gen_us = min(gen_us, (time.perf_counter() - t0) * 1e6)
        t0 = time.perf_counter()
        best, _, tried = price_candidates(iter(short), hw,
                                          store_stage_options, calibration)
        t_short = time.perf_counter() - t0
        t1 = time.perf_counter()
        exh = tune(shape, hw, dataflows=dataflows, elem_bytes=elem_bytes,
                   max_candidates=max_exhaustive,
                   store_stage_options=store_stage_options,
                   calibration=calibration)
        t_exh = time.perf_counter() - t1
        ratio = (best[0] / cost(exh.report)) if best is not None \
            else float("inf")
        per_shape.append({
            "shape": [shape.m, shape.n, shape.k],
            "shortlist": len(short),
            "priced": tried,
            "exhaustive_priced": exh.candidates_tried,
            "gen_us": round(gen_us, 1),
            "tune_us": round(t_short * 1e6, 1),
            "exhaustive_us": round(t_exh * 1e6, 1),
            "cost_ratio": ratio,
            "top1": bool(ratio <= 1.0 + TOP1_TIE_RTOL),
        })
    n = max(len(per_shape), 1)
    ratios = [r["cost_ratio"] for r in per_shape
              if math.isfinite(r["cost_ratio"])]
    geomean = math.exp(sum(math.log(r) for r in ratios) / len(ratios)) \
        if ratios else float("inf")
    return {
        "shapes": len(per_shape),
        "k": k,
        "top1_rate": sum(r["top1"] for r in per_shape) / n,
        "max_cost_ratio": max([r["cost_ratio"] for r in per_shape],
                              default=float("inf")),
        "geomean_cost_ratio": geomean,
        "mean_shortlist": sum(r["shortlist"] for r in per_shape) / n,
        "mean_gen_us": round(sum(r["gen_us"] for r in per_shape) / n, 1),
        "max_gen_us": round(max([r["gen_us"] for r in per_shape],
                                default=0.0), 1),
        "mean_speedup_vs_exhaustive": round(
            sum(r["exhaustive_us"] for r in per_shape)
            / max(sum(r["tune_us"] for r in per_shape), 1e-9), 1),
        "per_shape": per_shape,
    }
