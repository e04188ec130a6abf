"""Measured calibration of the SoftHier cost model (the paper's "connecting a
deployment toolchain with a configurable executable model", closed as a loop).

The analytical model in `sim/perf.py` prices a schedule from hardware
constants alone — a *prior*. This module fits that prior to the machine it is
actually deployed on, TVM/Ansor-style (PAPERS.md), with a deliberately tiny
learned layer: one scale factor per resource class.

Model: a report attributes its predicted `total_time` to compute / DMA / NoC
via `PerfReport.resource_shares()`; the fitted predictor is

    measured ~= a * (total * share_c) + b * (total * share_d)
              + c * (total * share_n) + h * n_supersteps

so identity factors (a = b = c = 1, h = 0) reproduce the analytical
prediction exactly, and least squares over (prediction, measurement) pairs
absorbs the global units gap (simulated accelerator seconds vs wall seconds
on the local mesh), the per-resource mispricing that flips schedule
rankings, and the per-superstep launch/sync overhead that dominates on
hosts whose fabric is emulated.

Trust is explicit: `fit_profile` only sets `fit_ok` when the fit explains the
measurements (R^2 over threshold), does not *worsen* rank agreement on its
own fit set, and its picks' measured time is no worse than the uncalibrated
picks'. Downstream (autotuner / Planner) uses the calibrated ranking — and
widens the DEFAULT search space to the hierarchical compositions — only for
trusted profiles; an untrusted profile degrades to the analytical prior.

`measure_modes` is the measurement harness: every executable mode (the
shared `MODE_CASES` table below) runs the same GEMM grid on a `DistMesh`
of `hw.grid` ranks, lowering asserted clean before timing, yielding the
(PerfReport, measured seconds) pairs the fit consumes. The ranks are
NCCL processes, one a card, or gloo CPU processes when the caller asks for
the CPU (the reference's fake CPU devices); the one-card 1x1 mesh cannot
host the table (three of its rows degrade there), so it raises. Profiles
persist next to the plan cache keyed by hardware fingerprint
(`save_profile` / `load_profile`), so a warmed deployment directory
carries its calibration, and a profile written by the reference package
loads here.

Everything except `time_best_of` / `measure_modes` / `calibrate_mesh` is
free of `torch.distributed` (the fit runs device-free in tests and on
machines that only replay persisted measurements).
"""
from __future__ import annotations

import dataclasses
import hashlib
import itertools
import json
import math
import os
import tempfile
import time
from typing import Dict, List, Optional, Sequence, Tuple

from repro_torch.core.schedule import GEMMShape, Schedule, Tiling
from repro_torch.hw.config import AcceleratorConfig
from repro_torch.sim.perf import PerfReport

PROFILE_SCHEMA_VERSION = 1

# fit-trust gates (see fit_profile): explain the data, don't hurt the
# rankings you were fitted to fix. The R^2 floor is deliberately mild — the
# sharp gates are the rank ones (agreement must not drop, and the calibrated
# picks' measured time must not exceed the analytical picks') because
# ranking is what the tuner consumes.
FIT_R2_THRESHOLD = 0.5
FIT_MIN_SAMPLES = 6


# ---------------------------------------------------------------------------
# The measurement record
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class CalibrationSample:
    """One (schedule prediction, measured execution) pair."""
    shape: Tuple[int, int, int]        # (M, N, K)
    dataflow: str                      # Schedule.dataflow
    mode: str                          # ExecPlan mode it lowered to
    report: PerfReport                 # analytical prediction
    measured_s: float                  # wall seconds on the local mesh

    def to_dict(self) -> Dict[str, object]:
        return {"shape": list(self.shape), "dataflow": self.dataflow,
                "mode": self.mode, "report": self.report.to_dict(),
                "measured_s": self.measured_s}

    @classmethod
    def from_dict(cls, d: Dict[str, object]) -> "CalibrationSample":
        return cls(shape=tuple(d["shape"]), dataflow=d["dataflow"],
                   mode=d["mode"], report=PerfReport.from_dict(d["report"]),
                   measured_s=d["measured_s"])


def _features(report: PerfReport) -> Tuple[float, float, float, float]:
    """The fit's X row: per-resource attribution of the predicted total,
    plus the superstep count (per-step launch/sync overhead is the term
    that dominates on hosts where the fabric is emulated — its identity
    coefficient is 0, so the prior is reproducible exactly)."""
    sc, sd, sn = report.resource_shares()
    t = report.total_time
    return (t * sc, t * sd, t * sn, float(report.n_supersteps))


# ---------------------------------------------------------------------------
# The fitted artifact
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class CalibrationProfile:
    """Per-resource scale factors fitted to measured mode efficiency.

    `fit_ok` is the trust bit: only a trusted profile changes autotuner
    behaviour (calibrated ranking + hierarchical compositions in the DEFAULT
    search space). An identity profile with `fit_ok=False` is the explicit
    "no usable calibration" value — it predicts exactly the analytical prior.
    """
    hw_name: str
    hw_digest: str
    compute_scale: float = 1.0
    dma_scale: float = 1.0
    noc_scale: float = 1.0
    # fitted seconds of launch/sync overhead per superstep (0 = none; the
    # dominant term on hosts where the fabric is emulated)
    step_overhead_s: float = 0.0
    # fit-quality record
    n_samples: int = 0
    r2: float = 0.0
    geomean_ratio: float = 1.0          # geomean(measured / calibrated pred)
    rank_agreement_before: float = 0.0  # analytical argmin == measured argmin
    rank_agreement_after: float = 0.0   # calibrated argmin == measured argmin
    picks_measured_ratio: float = 1.0   # geomean measured(calibrated picks)
                                        #       / measured(analytical picks)
    fit_ok: bool = False
    schema_version: int = PROFILE_SCHEMA_VERSION

    def digest(self) -> str:
        """Stable id of this profile (recorded on calibrated plans/reports)."""
        blob = json.dumps(self.to_dict(), sort_keys=True)
        return hashlib.sha256(blob.encode()).hexdigest()[:12]

    def predict(self, report: PerfReport) -> float:
        """Calibrated total-time prediction for an analytical report."""
        fc, fd, fn, steps = _features(report)
        return (self.compute_scale * fc + self.dma_scale * fd
                + self.noc_scale * fn + self.step_overhead_s * steps)

    @classmethod
    def identity(cls, hw: AcceleratorConfig, n_samples: int = 0,
                 fit_ok: bool = False) -> "CalibrationProfile":
        from repro_torch.deploy.plan import hw_fingerprint
        return cls(hw_name=hw.name, hw_digest=hw_fingerprint(hw),
                   n_samples=n_samples, fit_ok=fit_ok)

    def to_dict(self) -> Dict[str, object]:
        return dataclasses.asdict(self)

    def to_json(self) -> str:
        return json.dumps(self.to_dict(), indent=1, sort_keys=True)

    @classmethod
    def from_dict(cls, d: Dict[str, object]) -> "CalibrationProfile":
        version = d.get("schema_version")
        if version != PROFILE_SCHEMA_VERSION:
            raise ValueError(f"calibration schema version {version!r} not "
                             f"supported (reader is at "
                             f"{PROFILE_SCHEMA_VERSION})")
        return cls(**d)

    @classmethod
    def from_json(cls, text: str) -> "CalibrationProfile":
        return cls.from_dict(json.loads(text))

    def describe(self) -> str:
        return (f"calibration[{self.hw_name} n={self.n_samples} "
                f"scales=({self.compute_scale:.3g},{self.dma_scale:.3g},"
                f"{self.noc_scale:.3g}) step={self.step_overhead_s:.3g}s "
                f"r2={self.r2:.3f} "
                f"{'trusted' if self.fit_ok else 'UNTRUSTED'}]")


# ---------------------------------------------------------------------------
# Least-squares fit
# ---------------------------------------------------------------------------

N_FEATURES = 4          # compute, dma, noc attributions + superstep count


def _lstsq(rows: List[Tuple[float, ...]],
           y: List[float]) -> Optional[Tuple[float, ...]]:
    """Non-negative least squares over the feature columns, by best-subset
    enumeration (2^N candidate supports — exact, dependency-free, and
    deterministic, which a wobbliness-prone iterative NNLS is not)."""
    import numpy as np
    X = np.asarray(rows, dtype=np.float64)
    yv = np.asarray(y, dtype=np.float64)
    best: Optional[Tuple[float, Tuple[float, ...]]] = None
    for support in itertools.product((0, 1), repeat=N_FEATURES):
        idx = [i for i in range(N_FEATURES) if support[i]]
        if idx:
            sol, *_ = np.linalg.lstsq(X[:, idx], yv, rcond=None)
            if not np.all(np.isfinite(sol)) or np.any(sol < 0.0):
                continue
            coefs = [0.0] * N_FEATURES
            for i, c in zip(idx, sol):
                coefs[i] = float(c)
        else:
            coefs = [0.0] * N_FEATURES
        resid = yv - X @ np.asarray(coefs)
        sse = float(resid @ resid)
        if best is None or sse < best[0] - 1e-18:
            best = (sse, tuple(coefs))
    if best is None or all(c == 0.0 for c in best[1]):
        return None
    return best[1]


def is_trusted(profile) -> bool:
    """THE trust predicate every downstream ranker shares: only a profile
    that passed fit_profile's gates may change tuner behaviour."""
    return profile is not None and getattr(profile, "fit_ok", False)


def ranking_cost(profile):
    """The cost function a tuner ranks candidates by under `profile`:
    the calibrated prediction when trusted, else the analytical prior."""
    if is_trusted(profile):
        return profile.predict
    return lambda report: report.total_time


def rank_stats(samples: Sequence[CalibrationSample],
               cost_fn) -> Tuple[float, float, int]:
    """(rank agreement with the measured argmin, geomean measured time of
    the cost_fn picks, number of groups) across shapes that measured more
    than one mode. Shared by fit_profile's trust gate and
    benchmarks/calibration_bench.py — the CI bar `calibrated picks measure
    no worse` is exactly the gate's own statistic, so the two cannot
    drift."""
    by_shape: Dict[Tuple[int, int, int], List[CalibrationSample]] = {}
    for s in samples:
        by_shape.setdefault(s.shape, []).append(s)
    agree, groups, log_sum = 0, 0, 0.0
    for group in by_shape.values():
        if len(group) < 2:
            continue
        groups += 1
        pick = min(group, key=lambda s: cost_fn(s.report))
        measured_best = min(group, key=lambda s: s.measured_s)
        if pick.mode == measured_best.mode:
            agree += 1
        log_sum += math.log(max(pick.measured_s, 1e-30))
    if not groups:
        return 1.0, 1.0, 0
    return agree / groups, math.exp(log_sum / groups), groups


def fit_profile(samples: Sequence[CalibrationSample], hw: AcceleratorConfig,
                r2_threshold: float = FIT_R2_THRESHOLD,
                min_samples: int = FIT_MIN_SAMPLES) -> CalibrationProfile:
    """Least-squares per-resource scale factors from measured samples.

    Degenerate inputs (too few samples, non-positive measurements,
    rank-deficient features, zero variance) fall back to the identity
    profile with `fit_ok=False` — never a half-fitted profile.
    """
    import numpy as np
    from repro_torch.deploy.plan import hw_fingerprint

    clean = [s for s in samples
             if s.measured_s > 0.0 and s.report.total_time > 0.0]
    if len(clean) < max(3, min_samples):
        return CalibrationProfile.identity(hw, n_samples=len(clean))
    rows = [_features(s.report) for s in clean]
    y = [s.measured_s for s in clean]
    # genuine rank deficiency is handled inside _lstsq: a support whose
    # columns cannot fit returns non-finite/negative solutions and is
    # skipped, and an all-zero best support yields None -> identity below
    coefs = _lstsq(rows, y)
    if coefs is None:
        return CalibrationProfile.identity(hw, n_samples=len(clean))
    a, b, c, h = coefs

    yv = np.asarray(y)
    pred = np.asarray(rows) @ np.asarray(coefs)
    sse = float(np.sum((yv - pred) ** 2))
    sst = float(np.sum((yv - yv.mean()) ** 2))
    if sst <= 0.0:                      # all measurements identical
        return CalibrationProfile.identity(hw, n_samples=len(clean))
    r2 = 1.0 - sse / sst
    ratios = np.log(np.maximum(yv, 1e-30) / np.maximum(pred, 1e-30))
    geomean_ratio = float(np.exp(ratios.mean()))

    profile = CalibrationProfile(
        hw_name=hw.name, hw_digest=hw_fingerprint(hw),
        compute_scale=a, dma_scale=b, noc_scale=c, step_overhead_s=h,
        n_samples=len(clean), r2=r2, geomean_ratio=geomean_ratio)
    before, before_pick_t, _ = rank_stats(clean, lambda r: r.total_time)
    after, after_pick_t, _ = rank_stats(clean, profile.predict)
    picks_ratio = (after_pick_t / before_pick_t if before_pick_t > 0.0
                   else 1.0)
    fit_ok = (r2 >= r2_threshold and after >= before
              and picks_ratio <= 1.0 + 1e-9)
    return dataclasses.replace(profile,
                               rank_agreement_before=before,
                               rank_agreement_after=after,
                               picks_measured_ratio=picks_ratio,
                               fit_ok=fit_ok)


# ---------------------------------------------------------------------------
# Persistence (alongside the plan cache, keyed by hardware fingerprint)
# ---------------------------------------------------------------------------

def _profile_path(cache_dir: str, hw_digest: str) -> str:
    return os.path.join(cache_dir, f"calibration_{hw_digest}.profile.json")


def save_profile(cache_dir: str, profile: CalibrationProfile) -> str:
    """Persist a profile next to the plans it calibrates (atomic publish)."""
    os.makedirs(cache_dir, exist_ok=True)
    path = _profile_path(cache_dir, profile.hw_digest)
    fd, tmp = tempfile.mkstemp(dir=cache_dir, suffix=".tmp")
    try:
        with os.fdopen(fd, "w") as f:
            f.write(profile.to_json())
        os.replace(tmp, path)
    except BaseException:
        if os.path.exists(tmp):
            os.unlink(tmp)
        raise
    return path


def _samples_path(cache_dir: str, hw_digest: str) -> str:
    return os.path.join(cache_dir, f"calibration_{hw_digest}.samples.json")


def save_samples(cache_dir: str, hw_digest: str,
                 samples: Sequence[CalibrationSample]) -> str:
    """Persist the measurements a profile was fitted from, next to it.

    The persisted samples let a later run compute predicted-vs-measured
    drift (`repro_torch.obs.drift.DriftMonitor`) against the persisted profile
    WITHOUT re-running the measurement harness — serve/dryrun report drift
    from the calibration run's ground truth."""
    os.makedirs(cache_dir, exist_ok=True)
    path = _samples_path(cache_dir, hw_digest)
    doc = {"schema_version": PROFILE_SCHEMA_VERSION, "hw_digest": hw_digest,
           "samples": [s.to_dict() for s in samples]}
    fd, tmp = tempfile.mkstemp(dir=cache_dir, suffix=".tmp")
    try:
        with os.fdopen(fd, "w") as f:
            json.dump(doc, f, indent=1, sort_keys=True)
        os.replace(tmp, path)
    except BaseException:
        if os.path.exists(tmp):
            os.unlink(tmp)
        raise
    return path


def load_samples(cache_dir: str,
                 hw: AcceleratorConfig) -> List[CalibrationSample]:
    """The persisted samples for `hw`, or [] (missing / corrupt /
    incompatible schema / fingerprint mismatch are all misses)."""
    from repro_torch.deploy.plan import hw_fingerprint
    digest = hw_fingerprint(hw)
    path = _samples_path(cache_dir, digest)
    try:
        with open(path) as f:
            doc = json.load(f)
        if (doc.get("schema_version") != PROFILE_SCHEMA_VERSION
                or doc.get("hw_digest") != digest):
            return []
        return [CalibrationSample.from_dict(d) for d in doc["samples"]]
    except (OSError, ValueError, KeyError, TypeError):
        return []


def load_profile(cache_dir: str,
                 hw: AcceleratorConfig) -> Optional[CalibrationProfile]:
    """The persisted profile for `hw`, or None (missing / corrupt /
    incompatible schema / fingerprint mismatch are all misses)."""
    from repro_torch.deploy.plan import hw_fingerprint
    digest = hw_fingerprint(hw)
    path = _profile_path(cache_dir, digest)
    try:
        with open(path) as f:
            profile = CalibrationProfile.from_json(f.read())
    except (OSError, ValueError, KeyError, TypeError,
            json.JSONDecodeError):
        return None
    if profile.hw_digest != digest:
        return None
    return profile


# ---------------------------------------------------------------------------
# The measurement harness table (the harness itself joins with the benchmarks slice)
# ---------------------------------------------------------------------------

# label -> (schedule dataflow, tiling/owner knobs); THE table of executable
# modes — the measurement harness and benchmarks/routing_bench.py's
# efficiency harness both consume it, so a new mode lands in the
# calibration fit and the efficiency matrix together or not at all. Each
# case must lower to exactly its label on a square mesh >= 4x4 (asserted
# before timing).
MODE_CASES: Tuple[Tuple[str, str, Dict[str, object]], ...] = (
    ("summa", "summa", {}),
    ("cannon", "systolic", {}),
    ("splitk_summa", "splitk_summa", {"gk": 2, "owner": "round_robin"}),
    ("hierarchical", "summa_over_systolic", {}),
    ("outer_systolic", "systolic_over_summa", {}),
)

DEFAULT_GEMM_GRID: Tuple[Tuple[int, int, int], ...] = (
    (256, 256, 512), (512, 256, 1024), (512, 512, 512), (256, 512, 2048),
)


def build_mode_schedule(dataflow: str, knobs: Dict[str, object],
                        rows: int, cols: int,
                        shape: Tuple[int, int, int],
                        elem_bytes: int = 1,
                        inner_kernel=None, overlap: bool = False) -> Schedule:
    """The Schedule for one MODE_CASES row on a rows x cols grid.

    The k sub-axis factors out of the column axis (gm * gn * gk covers the
    grid exactly), so the same schedule both prices with the analytical
    model on an `AcceleratorConfig` of that grid AND lowers to exactly its
    labelled mode on the matching mesh. `inner_kernel`/`overlap` pass
    through to the schedule so the kernel benchmark can measure the same
    mode with and without the intra-device level engaged.
    """
    gk = int(knobs.get("gk", 1))
    return Schedule(GEMMShape(*shape), Tiling(rows, cols // gk, gk, tk=64),
                    dataflow, reduce_owner=str(knobs.get("owner", "first")),
                    inner=(2, 2), elem_bytes=elem_bytes,
                    inner_kernel=inner_kernel, overlap=overlap)


def _wait(out, mesh) -> None:
    """Block until `out` is computed on every rank of `mesh`: the card's
    queue drained (a CUDA mesh), then a barrier over the mesh's world (a
    multi-rank mesh; the mode bodies' collectives run on the host, so
    device events alone would not bound them)."""
    import torch
    if out.is_cuda:
        torch.cuda.synchronize(out.device)
    if getattr(mesh, "size", 1) > 1:
        import torch.distributed as dist
        dist.barrier()


def time_best_of(fn, a, b, reps: int, mesh=None) -> float:
    """Best-of-`reps` wall seconds, 3 executions per rep, after one
    warm call (the shared timing discipline of the measurement harness
    and the routing benchmark). Waits on every rank of `mesh` (`_wait`)
    before reading the clock."""
    _wait(fn(a, b), mesh)                    # warm
    best = float("inf")
    for _ in range(max(1, reps)):
        t0 = time.perf_counter()
        for _ in range(3):
            out = fn(a, b)
        _wait(out, mesh)
        best = min(best, (time.perf_counter() - t0) / 3)
    return best


def _world_mesh(grid: Tuple[int, int], row_axis: str, col_axis: str):
    """A `grid` `DistMesh` over the initialised world, on its backend's
    device: the current card for NCCL, the CPU for gloo."""
    import torch
    import torch.distributed as dist

    from repro_torch.launch.mesh import make_dist_mesh
    if not (dist.is_available() and dist.is_initialized()):
        raise ValueError(f"measure_modes needs a mesh of {grid[0]}x{grid[1]} "
                         f"ranks: initialise a torch.distributed world of "
                         f"that size or pass mesh=")
    device = (torch.device("cuda", torch.cuda.current_device())
              if dist.get_backend() == "nccl" else torch.device("cpu"))
    return make_dist_mesh(tuple(grid), device, (row_axis, col_axis))


def measure_modes(hw: AcceleratorConfig, mesh=None,
                  gemms: Sequence[Tuple[int, int, int]] = DEFAULT_GEMM_GRID,
                  reps: int = 2,
                  row_axis: str = "data", col_axis: str = "model",
                  ) -> List[CalibrationSample]:
    """Execute every mode over a GEMM shape grid on the mesh.

    For each (GEMM, mode): the schedule is priced with the analytical model
    on `hw`, its lowering onto `mesh` is asserted clean (a silent degrade
    would pair `auto`'s measurement with another mode's prediction), and the
    execution is timed best-of-`reps`, 3 calls per rep after a warm call.
    `hw.grid` must match the mesh so prediction and measurement describe
    the same machine. `mesh=None` builds one over the initialised world.
    Every rank makes the whole operands (the modes take whole operands)
    from the same seed.
    """
    import numpy as np
    import torch

    from repro_torch.core.gemm import dit_gemm
    from repro_torch.core.lower import lower_schedule
    from repro_torch.core.schedule import build_program
    from repro_torch.sim.perf import estimate

    if mesh is None:
        mesh = _world_mesh(hw.grid, row_axis, col_axis)
    rows, cols = (mesh.shape[row_axis], mesh.shape[col_axis])
    if (rows, cols) != tuple(hw.grid):
        raise ValueError(f"mesh {rows}x{cols} does not match hw.grid "
                         f"{hw.grid}; the profile would pair predictions "
                         f"and measurements from different machines")

    rng = np.random.default_rng(0)
    samples: List[CalibrationSample] = []
    with torch.inference_mode():
        for (M, N, K) in gemms:
            a = torch.as_tensor(rng.standard_normal((M, K)),
                                dtype=torch.float32).to(mesh.device)
            b = torch.as_tensor(rng.standard_normal((K, N)),
                                dtype=torch.float32).to(mesh.device)
            for label, df, kw in MODE_CASES:
                sched = build_mode_schedule(df, kw, rows, cols, (M, N, K),
                                            elem_bytes=hw.tile.elem_bytes)
                ep = lower_schedule(sched, mesh, row_axis, col_axis,
                                    shape=(M, N, K))
                if ep.mode != label or ep.degraded:
                    raise RuntimeError(f"{df} lowered to {ep.describe()}, "
                                       f"expected clean {label}")
                report = estimate(build_program(sched, hw), hw)
                t = time_best_of(
                    lambda x, y, e=ep: dit_gemm(x, y, mesh, exec_plan=e,
                                                row_axis=row_axis,
                                                col_axis=col_axis),
                    a, b, reps, mesh)
                samples.append(CalibrationSample(
                    shape=(M, N, K), dataflow=df, mode=label,
                    report=report, measured_s=t))
    return samples


def calibrate_mesh(hw: AcceleratorConfig, mesh=None,
                   gemms: Sequence[Tuple[int, int, int]] = DEFAULT_GEMM_GRID,
                   reps: int = 2,
                   ) -> Tuple[CalibrationProfile, List[CalibrationSample]]:
    """measure_modes + fit_profile in one call (the dryrun/bench entry)."""
    samples = measure_modes(hw, mesh, gemms=gemms, reps=reps)
    return fit_profile(samples, hw), samples
