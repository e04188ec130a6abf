"""Deployment-schedule abstraction (paper §3).

A `Schedule` is the complete, parameterizable description DiT generates code
from: (1) tiling & mapping — how the GEMM is decomposed over the logical tile
grid, including 3-D split-K and cluster index remap; (2) data layout — split +
placement schemes per matrix; (3) dataflow — which pattern primitive moves the
data (baseline / SUMMA / systolic / hierarchical / split-K) and its knobs
(double buffering, store pipeline stages).

`build_program(schedule, hw)` dispatches to the dataflow builders and returns
the BSP `Program` that the simulator executes and the cost model prices.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, Optional, Tuple

from repro_torch.core import layout as layout_lib
from repro_torch.core.ir import ELEM_BYTES_OF_DTYPE, Program
from repro_torch.core.remap import ClusterRemap
from repro_torch.hw.config import AcceleratorConfig

# Dispatch-time working-set budget for an inner kernel (bytes). A v5e has
# ~128 MB VMEM but Pallas double-buffers every operand block, so the planner
# and `kernels/ops.pick_block_shape` share this much tighter cap; lowering
# demotes (reason `inner_kernel_too_large`) any persisted kernel that
# exceeds it instead of letting the dispatch OOM VMEM.
INNER_VMEM_BUDGET = 8 * 1024 * 1024


@dataclasses.dataclass(frozen=True)
class GEMMShape:
    m: int
    n: int
    k: int

    def flops(self) -> int:
        return 2 * self.m * self.n * self.k

    def min_bytes(self, elem_bytes: int = 4) -> int:
        """Compulsory HBM traffic: read A and B once, write C once."""
        return elem_bytes * (self.m * self.k + self.k * self.n + self.m * self.n)

    def intensity(self, elem_bytes: int = 4) -> float:
        return self.flops() / self.min_bytes(elem_bytes)


@dataclasses.dataclass(frozen=True)
class AttnShape:
    """One fused-attention composition problem (FlatAttention).

    Unlike a GEMM, attention has no single (m, n, k): the QKᵀ and PV
    contractions share the KV sequence axis and are glued by the online
    softmax, so the planner keys attention work on the full geometry.
    Separate `d` (QK head dim) and `dv` (V head dim) cover MLA's absorbed
    decode, whose keys are rank+rope wide but whose values are rank wide.
    Frozen + hashable so it can serve as a plan-cache key exactly like
    `GEMMShape`.
    """
    b: int              # batch
    sq: int             # query sequence length (decode: 1 per step)
    skv: int            # key/value sequence length (decode: cache capacity)
    h: int              # query heads
    hkv: int            # KV heads (GQA groups; 1 = MQA / MLA-absorbed)
    d: int              # QK head dim
    dv: int             # V head dim
    causal: bool = True

    def flops(self) -> int:
        """QKᵀ (2·b·h·sq·skv·d) + PV (2·b·h·sq·skv·dv)."""
        return 2 * self.b * self.h * self.sq * self.skv * (self.d + self.dv)

    def min_bytes(self, elem_bytes: int = 4) -> int:
        """Compulsory HBM traffic: read Q and KV once, write O once."""
        q = self.b * self.sq * self.h * self.d
        kv = self.b * self.skv * self.hkv * (self.d + self.dv)
        o = self.b * self.sq * self.h * self.dv
        return elem_bytes * (q + kv + o)

    def intensity(self, elem_bytes: int = 4) -> float:
        return self.flops() / self.min_bytes(elem_bytes)

    def describe(self) -> str:
        c = "causal" if self.causal else "full"
        return (f"attn[b{self.b} q{self.sq} kv{self.skv} "
                f"h{self.h}/{self.hkv} d{self.d}v{self.dv} {c}]")


# The fused attention dataflow name. Deliberately NOT in `DATAFLOWS`: every
# name there has a BSP `build_program` builder, while flat attention lowers
# through `lower_attention` to its own exec modes and is priced by
# `sim.perf.estimate_attention`.
ATTN_DATAFLOW = "flat_attention"

# collective compositions the fused dataflow can run as (docs/dataflows.md):
#   merge — KV row-sharded, every device scans its local KV, one final
#           pmax/psum combine of (m, l, acc) partials across the row axis;
#   ring  — Q additionally row-sharded over sq, KV blocks rotate around a
#           `ppermute` ring so each device sees the full KV stream.
ATTN_COMPOSITIONS = ("merge", "ring")


@dataclasses.dataclass(frozen=True)
class AttnSchedule:
    """One point in the fused-attention deployment space.

    The candidate space is tiny compared to GEMMs — composition × KV chunk —
    because the head/batch mapping is dictated by the mesh (head sharding is
    a lowering legality question, not a tunable). `kv_chunk` is the KV tile
    one superstep streams through L1 (larger amortizes softmax passes and
    barriers, smaller fits the working set).
    """
    shape: AttnShape
    composition: str = "merge"
    kv_chunk: int = 256
    dataflow: str = ATTN_DATAFLOW
    elem_bytes: int = 4
    elem_dtype: str = ""
    # parity with Schedule's dispatch contract (pattn provenance rows carry
    # inner_kernel/overlap keys like pmm's; attention has no inner kernel)
    inner_kernel: Optional[InnerKernel] = None
    overlap: bool = False

    def describe(self) -> str:
        return (f"{self.dataflow}/{self.composition}"
                f"[kv_chunk={self.kv_chunk}] {self.shape.describe()}")


@dataclasses.dataclass(frozen=True)
class Tiling:
    """3-D mapping of the GEMM onto the logical grid (paper §3.1).

    The logical grid (gm x gn x gk) has gm*gn*gk == n_tiles. gk == 1 is 2-D
    output-stationary tiling (one tile owns one output tile); gk > 1 is 3-D
    split-K (gk tiles collaborate on one output tile and NoC-reduce partials).
    iter_m/iter_n/iter_k sweep the grid over GEMMs bigger than one coverage.
    """
    gm: int
    gn: int
    gk: int = 1
    iter_m: int = 1
    iter_n: int = 1
    tk: int = 128               # K-chunk per superstep (L1-resident)

    def tile_dims(self, shape: GEMMShape) -> Tuple[int, int, int]:
        """(TM, TN, K_local): the per-tile workload."""
        tm = shape.m // (self.gm * self.iter_m)
        tn = shape.n // (self.gn * self.iter_n)
        k_local = shape.k // self.gk
        return tm, tn, k_local

    def validate(self, shape: GEMMShape, n_tiles: int) -> None:
        if self.gm * self.gn * self.gk != n_tiles:
            raise ValueError(f"{self.gm}x{self.gn}x{self.gk} != {n_tiles} tiles")
        if shape.m % (self.gm * self.iter_m):
            raise ValueError(f"M={shape.m} not divisible by gm*iter_m="
                             f"{self.gm * self.iter_m}")
        if shape.n % (self.gn * self.iter_n):
            raise ValueError(f"N={shape.n} not divisible by gn*iter_n="
                             f"{self.gn * self.iter_n}")
        if shape.k % self.gk:
            raise ValueError(f"K={shape.k} not divisible by gk={self.gk}")
        k_local = shape.k // self.gk
        if k_local % self.tk and k_local > self.tk:
            raise ValueError(f"K_local={k_local} not divisible by tk={self.tk}")


@dataclasses.dataclass(frozen=True)
class InnerKernel:
    """Second schedule level: the intra-device (per-tile) kernel geometry.

    The outer `Tiling` maps the GEMM onto the tile grid; an `InnerKernel`
    maps each tile's local (TM x TN x K) contraction onto its matrix engine
    — block shape, operand pipeline depth, and compute element dtype. On the
    TPU target it parameterizes the Pallas `kernels/mmad` kernel (BlockSpec
    geometry + double-buffered VMEM streaming); in the cost model it prices
    MXU occupancy, pipeline refills per `bk` chunk, and the feed bandwidth
    at the kernel's element width. Frozen + hashable so it can ride on a
    `Schedule`, an `ExecPlan`, and through `jax.custom_vjp` nondiff args.
    """
    bm: int
    bn: int
    bk: int
    # operand pipeline depth: 2 = double-buffered (the next block streams
    # while the current one computes), 1 = serialized fetch/compute.
    depth: int = 2
    # compute element dtype (accumulation is always fp32); "" inherits the
    # schedule's element dtype at dispatch/pricing time.
    dtype: str = ""

    def elem_bytes(self, default: int = 4) -> int:
        return ELEM_BYTES_OF_DTYPE.get(self.dtype, default)

    def geometry(self) -> Tuple[int, int, int]:
        return (self.bm, self.bn, self.bk)

    def working_set_bytes(self, default_elem_bytes: int = 4) -> int:
        """Pipelined A/B blocks + the fp32 accumulator block."""
        eb = self.elem_bytes(default_elem_bytes)
        depth = max(1, self.depth)
        return ((self.bm * self.bk + self.bk * self.bn) * eb * depth
                + self.bm * self.bn * 4)

    def validate(self, budget: int = INNER_VMEM_BUDGET) -> None:
        """Legality rules, mirroring `Tiling.validate`."""
        if min(self.bm, self.bn, self.bk) < 1:
            raise ValueError(f"inner kernel blocks must be positive, got "
                             f"{self.bm}x{self.bn}x{self.bk}")
        if self.depth < 1:
            raise ValueError(f"pipeline depth must be >= 1, got {self.depth}")
        if self.dtype and self.dtype not in ELEM_BYTES_OF_DTYPE:
            raise ValueError(f"unknown inner-kernel dtype {self.dtype!r}; "
                             f"have {sorted(ELEM_BYTES_OF_DTYPE)}")
        ws = self.working_set_bytes()
        if ws > budget:
            raise ValueError(f"inner-kernel working set {ws} exceeds the "
                             f"{budget}-byte VMEM budget")

    def to_dict(self) -> Dict[str, object]:
        return {"bm": self.bm, "bn": self.bn, "bk": self.bk,
                "depth": self.depth, "dtype": self.dtype}

    @classmethod
    def from_dict(cls, d: Dict[str, object]) -> "InnerKernel":
        return cls(bm=int(d["bm"]), bn=int(d["bn"]), bk=int(d["bk"]),
                   depth=int(d.get("depth", 2)),
                   dtype=str(d.get("dtype", "")))

    def describe(self) -> str:
        dt = f":{self.dtype}" if self.dtype else ""
        return f"{self.bm}x{self.bn}x{self.bk}d{self.depth}{dt}"


# every name has both a BSP builder (build_program, simulator/cost model)
# and an explicit mesh lowering (repro_torch.core.lower) — the two hierarchical
# compositions resolve to distinct ExecPlan modes (systolic_over_summa ->
# outer_systolic, summa_over_systolic -> hierarchical); docs/dataflows.md
# tabulates the full mapping and its fallback chains.
DATAFLOWS = ("baseline", "summa", "systolic", "systolic_over_summa",
             "summa_over_systolic", "splitk_summa")


@dataclasses.dataclass(frozen=True)
class Schedule:
    """One point in DiT's deployment space."""
    shape: GEMMShape
    tiling: Tiling
    dataflow: str = "summa"
    remap: Optional[ClusterRemap] = None      # None -> identity (logical == physical)
    # layouts keyed by matrix name; None -> optimal_layout for that matrix.
    layouts: Optional[Dict[str, layout_lib.DataLayout]] = None
    double_buffer: bool = True
    # store pipeline stages for store-intensive cases (paper Insight 2 / Fig 8b)
    store_stages: int = 1
    # hierarchical schedules: inner group shape on the logical grid
    inner: Tuple[int, int] = (2, 2)
    # reduction-owner policy for split-K: which K-slice owner commits C
    reduce_owner: str = "first"               # 'first' | 'round_robin'
    elem_bytes: int = 4
    # L1 accumulator precision (4 = fp32; 2 models fp16 accumulation, which
    # the fp8 deployment needs for very large C tiles to fit 384 KB L1).
    acc_bytes: int = 4
    # explicit element dtype name ("" = resolved from elem_bytes + the
    # hardware's native dtype; see `elem_dtype_name`) — fp8 deployments
    # price and lower as float8_e4m3, not as the byte-width's int8 default.
    elem_dtype: str = ""
    # second schedule level: the per-tile kernel geometry (None = the
    # target's default kernel, i.e. whatever XLA picks for the local dot).
    inner_kernel: Optional[InnerKernel] = None
    # overlap the ring dataflows' ppermute hops with inner-tile compute
    # (issue the collective for step s+1 before consuming step s's panels).
    # No-op for the broadcast dataflows, which consume a panel in the same
    # superstep it arrives.
    overlap: bool = False

    def describe(self) -> str:
        t = self.tiling
        r = f" remap={self.remap.logical}" if self.remap else ""
        ik = f" ik={self.inner_kernel.describe()}" if self.inner_kernel else ""
        ov = " overlap" if self.overlap else ""
        return (f"{self.dataflow}[{t.gm}x{t.gn}x{t.gk} iters=({t.iter_m},{t.iter_n}) "
                f"tk={t.tk}]{r} db={int(self.double_buffer)} "
                f"stages={self.store_stages}{ik}{ov}")


# byte-width -> default dtype name, the legacy direction (re-exported by
# core.dataflow.common for its existing importers). Lossy on purpose — 1
# byte could be int8 OR float8_e4m3 — which is why `elem_dtype_name` below
# consults the schedule's and the hardware's explicit dtype first.
DTYPE_OF_BYTES = {1: "int8", 2: "float16", 4: "float32"}


def elem_dtype_name(sched: Schedule,
                    hw: Optional[AcceleratorConfig] = None) -> str:
    """The element dtype a schedule deploys under.

    Resolution order: the schedule's explicit `elem_dtype`; the hardware's
    native engine dtype when its byte width matches the schedule's
    `elem_bytes` (the GH200 preset's fp8); the legacy byte-width default.
    """
    if sched.elem_dtype:
        return sched.elem_dtype
    hw_dt = getattr(getattr(hw, "tile", None), "elem_dtype", "")
    if hw_dt and ELEM_BYTES_OF_DTYPE.get(hw_dt) == sched.elem_bytes:
        return hw_dt
    return DTYPE_OF_BYTES[sched.elem_bytes]


def default_elem_dtype(elem_bytes: int,
                       hw: Optional[AcceleratorConfig] = None) -> str:
    """`elem_dtype_name` for candidate generators that only have the byte
    width: the hardware's native dtype when the widths agree, else the
    legacy byte-width default."""
    hw_dt = getattr(getattr(hw, "tile", None), "elem_dtype", "")
    if hw_dt and ELEM_BYTES_OF_DTYPE.get(hw_dt) == elem_bytes:
        return hw_dt
    return DTYPE_OF_BYTES[elem_bytes]


def _aligned_block(dim: int, unit: int) -> int:
    """Largest of {4, 2, 1} x `unit` that divides `dim` (falling back to the
    dim itself) — an engine-aligned block edge with no padding waste."""
    for mult in (4, 2, 1):
        b = unit * mult
        if b <= dim and dim % b == 0:
            return b
    return dim


def inner_kernel_candidates(sched: Schedule, hw: AcceleratorConfig,
                            max_candidates: int = 3) -> Tuple[InnerKernel, ...]:
    """Closed-form inner-kernel shortlist for one outer schedule.

    Mirrors the analytic shortlist's derivation style at the second tiling
    level: block edges are the largest engine-aligned divisors of the tile
    dims (MXU occupancy), `bk` sweeps down from the full K-chunk (larger bk
    amortizes pipeline refills and the accumulator flush), and the pipeline
    depth degrades from double-buffered to serialized only when the deeper
    working set cannot fit the VMEM budget. Deterministic and ordered
    best-prior-first, so the pricing sweep's tie-break (first strict
    minimum wins) prefers the planner-visible kernel over the opaque
    XLA-default path at equal predicted cost.
    """
    tm, tn, k_local = sched.tiling.tile_dims(sched.shape)
    tk = min(sched.tiling.tk, k_local)
    if min(tm, tn, tk) < 1:
        return ()
    dtype = elem_dtype_name(sched, hw)
    t = hw.tile
    bm = _aligned_block(tm, t.ce_rows)
    bn = _aligned_block(tn, t.ce_cols)
    budget = min(t.l1_bytes, INNER_VMEM_BUDGET)
    out = []
    for bk in (tk, tk // 2, tk // 4):
        if bk < 1 or tk % bk:
            continue
        for depth in (2, 1):
            ik = InnerKernel(bm, bn, bk, depth=depth, dtype=dtype)
            if ik.working_set_bytes() <= budget:
                out.append(ik)
                break           # deeper pipeline strictly dominates at a bk
        if len(out) >= max_candidates:
            break
    return tuple(out)


def resolve_layouts(sched: Schedule, hw: AcceleratorConfig) -> Dict[str, layout_lib.DataLayout]:
    """Fill in default (optimal) layouts for matrices the user didn't pin."""
    tm, tn, k_local = sched.tiling.tile_dims(sched.shape)
    tk = min(sched.tiling.tk, k_local)
    shapes = {"A": (sched.shape.m, sched.shape.k),
              "B": (sched.shape.k, sched.shape.n),
              "C": (sched.shape.m, sched.shape.n)}
    tiles = {"A": (tm, tk), "B": (tk, tn), "C": (tm, tn)}
    out = dict(sched.layouts or {})
    for mat, shp in shapes.items():
        if mat not in out:
            out[mat] = layout_lib.optimal_layout(shp, *tiles[mat], hw.hbm.n_channels)
    return out


def build_program(sched: Schedule, hw: AcceleratorConfig) -> Program:
    """Dispatch to the dataflow pattern builders (paper §3.3.2)."""
    from repro_torch.core.dataflow import baseline, hierarchical, splitk, summa, systolic
    sched.tiling.validate(sched.shape, hw.n_tiles)
    builders = {
        "baseline": baseline.build,
        "summa": summa.build,
        "systolic": systolic.build,
        "systolic_over_summa": hierarchical.build_systolic_over_summa,
        "summa_over_systolic": hierarchical.build_summa_over_systolic,
        "splitk_summa": splitk.build,
    }
    if sched.dataflow not in builders:
        raise KeyError(f"unknown dataflow {sched.dataflow!r}; have {DATAFLOWS}")
    prog = builders[sched.dataflow](sched, hw)
    prog.validate(l1_capacity=hw.tile.l1_bytes)
    return prog
