"""Faithful schedule→mesh lowering (paper §3 applied to the TPU target).

`lower_schedule(schedule, mesh, row_axis, col_axis) -> ExecPlan` resolves a
tuned `Schedule` into the exact collective program the mesh will execute —
*before* dispatch, with every degradation recorded. The tuned deployment
schedule IS the program: the logical (gm × gn × gk) grid, the hierarchical
inner-group shape, and the reduction-owner policy all survive to execution
instead of collapsing onto whatever 2-D pattern happens to fit.

Three layers of resolution:

1. **Dataflow mapping** — each of the six `DATAFLOWS` has an explicit
   lowering (no silent default branch): `summa` → `summa`, `systolic` →
   `cannon`, `baseline` → `allgather`, `splitk_summa` → the 3-D
   `splitk_summa` mode, and the two hierarchical compositions resolve to
   *distinct* modes: `summa_over_systolic` (Fig. 6d) → `hierarchical`
   (outer SUMMA over inner Cannon groups) and `systolic_over_summa`
   (Fig. 6c) → `outer_systolic` (an outer Cannon ring of inner SUMMA
   groups — A/B chunks propagate between tile groups as a global
   wavefront over `ppermute` rings). Fig. 6c needs a square outer grid of
   at least 2×2 for its ring; otherwise it falls back to `hierarchical`
   with the reason recorded (`non_square_outer` / `outer_ring_too_small`).
2. **Mesh-view construction** — when a schedule needs more grid axes than
   the physical mesh exposes, `MeshView` describes sub-axis splits of the
   physical axes: a gk>1 split-K schedule factors gk out of the row or
   column axis (k-groups stay physically adjacent), so a 2×2×2 grid runs as
   true 3-D split-K on an 8-device mesh instead of collapsing to 1-D;
   hierarchical schedules split both axes into (outer, inner) per
   `Schedule.inner`. Lowering itself needs no devices (unit-testable with
   a bare namespace exposing `.shape`); materializing a view on a
   `DistMesh` gives the viewed mesh the process groups of its sub-axes,
   which `make_dist_mesh` created for every view `mesh_views` lists.
3. **Legality** — the chosen mode's divisibility preconditions are checked
   against the *actual* problem shape (not the schedule's tuned shape —
   bucketed transfers serve neighbours). Every miss appends a `Fallback`
   with a machine-readable reason and moves down the chain
   (e.g. `hierarchical → summa → auto`); nothing degrades silently.
   The inner kernel is held to the device the mesh is on: on a CPU mesh
   (and any mesh with no CUDA device) to the reference's VMEM budget,
   exactly as the reference lowers; on a CUDA mesh to the card's compiled
   tensor-core instances (`inner_kernel_no_instance`), so a plan priced on
   another view (`tpu-v5e-pod`, `softhier-gh200`) is demoted here, by
   name, and never reaches a launch that would have to swap its geometry.

`repro_torch.core.gemm.dit_gemm` consumes the ExecPlan; `models.matmul.pmm`
records it in `GemmContext.stats` so launchers report *why* routing
degraded, not just that it did. See docs/dataflows.md for the full
lowering table.

This module is importable without torch, so the deploy layer and
device-free tests can reason about lowering.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Dict, List, Mapping, Optional, Sequence, Tuple

from repro_torch.core.schedule import INNER_VMEM_BUDGET, tensor_core_instance
from repro_torch.hw.config import (H100_STREAM_MAX_M, H100_TC_INSTANCES,
                                   TENSOR_CORE_FAMILY)

# -- machine-readable fallback reasons --------------------------------------
# mode changes
NON_SQUARE_SYSTOLIC = "non_square_systolic"   # cannon needs dm == dn -> summa
NON_SQUARE_INNER = "non_square_inner"         # inner group not square -> summa
INNER_GRID_MISMATCH = "inner_grid_mismatch"   # inner group doesn't divide the mesh -> summa
NON_SQUARE_OUTER = "non_square_outer"         # Fig. 6c ring needs Om == On -> hierarchical
OUTER_RING_TOO_SMALL = "outer_ring_too_small"  # Om < 2: no ring to rotate -> hierarchical
GRID_MISMATCH = "grid_mismatch"               # gk factors into neither mesh axis -> 1-D splitk
GK_IS_ONE = "gk_is_one"                       # splitk_summa with gk == 1 IS 2-D summa
UNKNOWN_DATAFLOW = "unknown_dataflow"         # unrecognized name -> summa (paper default)
M_NOT_DIVISIBLE = "m_not_divisible"           # -> auto
N_NOT_DIVISIBLE = "n_not_divisible"           # -> auto
K_NOT_DIVISIBLE = "k_not_divisible"           # -> auto
# kwarg demotion (mode unchanged)
SCATTER_M_INDIVISIBLE = "scatter_m_indivisible"  # psum_scatter -> psum
INNER_KERNEL_TOO_LARGE = "inner_kernel_too_large"  # ik working set > VMEM -> XLA inner
INNER_KERNEL_NO_INSTANCE = "inner_kernel_no_instance"  # CUDA mesh: no tensor-core instance runs it -> the route's own
# fused-attention lowering (lower_attention)
ATTN_SEQ_NOT_DIVISIBLE = "attn_seq_not_divisible"    # ring needs sq % dm -> flat_merge
ATTN_KV_NOT_DIVISIBLE = "attn_kv_not_divisible"      # skv % dm -> unfused_attn
ATTN_HEADS_REPLICATED = "attn_heads_replicated"      # h/hkv vs dn -> replicate heads (kwarg demotion)
ATTN_UNKNOWN_COMPOSITION = "attn_unknown_composition"  # unrecognized -> flat_merge

REASONS = (NON_SQUARE_SYSTOLIC, NON_SQUARE_INNER, INNER_GRID_MISMATCH,
           NON_SQUARE_OUTER, OUTER_RING_TOO_SMALL, GRID_MISMATCH, GK_IS_ONE,
           UNKNOWN_DATAFLOW, M_NOT_DIVISIBLE, N_NOT_DIVISIBLE,
           K_NOT_DIVISIBLE, SCATTER_M_INDIVISIBLE, INNER_KERNEL_TOO_LARGE,
           INNER_KERNEL_NO_INSTANCE, ATTN_SEQ_NOT_DIVISIBLE, ATTN_KV_NOT_DIVISIBLE,
           ATTN_HEADS_REPLICATED, ATTN_UNKNOWN_COMPOSITION)

# modes an ExecPlan can resolve to (superset of gemm.MODES: the 3-D split-K
# and both hierarchical modes need a mesh view, so they are plan-only).
# flat_merge/flat_ring are the fused-attention compositions; unfused_attn is
# attention's explicit degrade target — the legacy projections+chunked_sdpa
# path, always reached WITH a recorded reason (never the silent `auto`).
EXEC_MODES = ("auto", "summa", "cannon", "splitk", "splitk_summa",
              "hierarchical", "outer_systolic", "allgather",
              "flat_merge", "flat_ring", "unfused_attn")

# sub-axis names introduced by mesh views
K_AXIS = "splitk"
INNER_SUFFIX = "_in"


@dataclasses.dataclass(frozen=True)
class Fallback:
    """One recorded degradation step of the lowering chain."""
    reason: str
    from_mode: str
    to_mode: str

    def describe(self) -> str:
        return f"{self.from_mode}->{self.to_mode}[{self.reason}]"


@dataclasses.dataclass(frozen=True)
class MeshView:
    """Sub-axis splits of a physical mesh, materialized at dispatch time.

    `splits` maps a physical axis name to the ordered (name, size) sub-axes
    it splits into (outer-major, so split products preserve device order and
    minor sub-axes stay physically adjacent). Axes not named pass through.
    """
    splits: Tuple[Tuple[str, Tuple[Tuple[str, int], ...]], ...]

    def axis_sizes(self, mesh) -> Dict[str, int]:
        """The viewed mesh's {axis: size} without materializing it."""
        out: Dict[str, int] = {}
        split_map = dict(self.splits)
        for ax in mesh.axis_names:
            if ax in split_map:
                out.update(split_map[ax])
            else:
                out[ax] = mesh.shape[ax]
        return out

    def materialize(self, mesh):
        """The viewed mesh, same device order. A `DistMesh` splits its axes
        over the process groups it already holds (`DistMesh.view`; creating
        a group is collective, so none is created here); a one-device mesh
        gains its size-1 sub-axes."""
        if hasattr(mesh, "view"):
            return mesh.view(self.splits)
        sizes = self.axis_sizes(mesh)
        if any(size != 1 for size in sizes.values()):
            raise ValueError(f"MeshView {self.splits} does not fit a "
                             f"one-device mesh")
        return dataclasses.replace(mesh, axis_names=tuple(sizes),
                                   shape=sizes)


def mesh_views(sizes: Mapping[str, int], row_axis: str = "data",
               col_axis: str = "model") -> Tuple[MeshView, ...]:
    """Every `MeshView` `lower_schedule` can name on a (row, col) mesh of
    these axis sizes, whatever the schedule: a split-K k sub-axis factored
    out of the column or the row axis, and each square inner group of the
    hierarchical compositions. A multi-rank mesh creates their process
    groups up front from this list."""
    dm, dn = int(sizes[row_axis]), int(sizes[col_axis])
    irow, icol = row_axis + INNER_SUFFIX, col_axis + INNER_SUFFIX
    views = []
    for gk in range(2, dn + 1):
        if dn % gk == 0:
            views.append(MeshView(splits=(
                (col_axis, ((col_axis, dn // gk), (K_AXIS, gk))),)))
    for gk in range(2, dm + 1):
        if dm % gk == 0:
            views.append(MeshView(splits=(
                (row_axis, ((row_axis, dm // gk), (K_AXIS, gk))),)))
    for ih in range(1, min(dm, dn) + 1):
        if dm % ih == 0 and dn % ih == 0:
            views.append(MeshView(splits=(
                (row_axis, ((row_axis, dm // ih), (irow, ih))),
                (col_axis, ((col_axis, dn // ih), (icol, ih))))))
    return tuple(views)


@dataclasses.dataclass(frozen=True)
class ExecPlan:
    """The resolved execution of one GEMM: mode + mesh view + kwargs + the
    fallback chain that produced them.

    `axes` maps roles -> axis names in the (viewed) mesh: always `row` and
    `col`; `k` for the split-K modes; `inner_row`/`inner_col` for
    hierarchical. `kwargs` carries mode knobs (`scatter`). `view` is None
    when the physical mesh is used as-is.
    """
    mode: str
    axes: Mapping[str, str]
    kwargs: Mapping[str, Any]
    view: Optional[MeshView]
    requested: str                      # the schedule's dataflow name
    grid: Tuple[int, int, int]          # the schedule's (gm, gn, gk)
    shape: Tuple[int, int, int]         # the actual (m, n, k) lowered for
    fallbacks: Tuple[Fallback, ...] = ()
    # resolved intra-device level: the schedule's InnerKernel (None -> XLA
    # picks the local GEMM) and whether ring hops overlap tile compute
    inner_kernel: Optional[Any] = None
    overlap: bool = False

    @property
    def degraded(self) -> bool:
        """Did the lowering land on `auto` (XLA places the collectives)?"""
        return any(f.to_mode == "auto" for f in self.fallbacks)

    def reasons(self) -> Tuple[str, ...]:
        return tuple(f.reason for f in self.fallbacks)

    def to_dict(self) -> Dict[str, Any]:
        """JSON-able form for traces / run reports (the mesh view is
        summarized by its axis splits; tuple kwargs become lists)."""
        return {
            "mode": self.mode,
            "requested": self.requested,
            "grid": list(self.grid),
            "shape": list(self.shape),
            "axes": dict(self.axes),
            "kwargs": {k: (list(v) if isinstance(v, tuple) else v)
                       for k, v in self.kwargs.items()},
            "view": ({ax: [list(sub) for sub in subs]
                      for ax, subs in self.view.splits}
                     if self.view is not None else None),
            "degraded": self.degraded,
            "fallbacks": [{"reason": f.reason, "from": f.from_mode,
                           "to": f.to_mode} for f in self.fallbacks],
            "inner_kernel": (self.inner_kernel.to_dict()
                             if self.inner_kernel is not None else None),
            "overlap": self.overlap,
        }

    def describe(self) -> str:
        chain = " ".join(f.describe() for f in self.fallbacks)
        gm, gn, gk = self.grid
        return (f"{self.requested}[{gm}x{gn}x{gk}] -> {self.mode}"
                + (f" ik={self.inner_kernel.describe()}"
                   if self.inner_kernel is not None else "")
                + (" overlap" if self.overlap else "")
                + (f" ({chain})" if chain else ""))


def _shape3(shape) -> Tuple[int, int, int]:
    if shape is None:
        raise ValueError("lower_schedule needs a problem shape: pass shape= "
                         "or a schedule with a .shape")
    if hasattr(shape, "m"):
        return int(shape.m), int(shape.n), int(shape.k)
    m, n, k = shape
    return int(m), int(n), int(k)


def on_cuda(mesh) -> bool:
    """Whether the mesh's tensors live on a CUDA device (`HostMesh` and
    `DistMesh` carry `.device`; a bare namespace or a jax mesh does not)."""
    return getattr(getattr(mesh, "device", None), "type", None) == "cuda"


def card_runs(ik, rows: int, operand_dtype: Optional[str] = None) -> bool:
    """Whether the card runs inner kernel `ik` on a device's block of
    `rows` rows: it names a compiled tensor-core instance
    (`H100_TC_INSTANCES`), the block has more rows than the stream kernels
    take, and, when the caller knows it, `operand_dtype` (the dtype the
    product is launched in, "" when its operands would not feed the
    tensor cores) is of the kernel's family."""
    inst = tensor_core_instance(ik)
    return (inst in H100_TC_INSTANCES and rows > H100_STREAM_MAX_M
            and (operand_dtype is None
                 or TENSOR_CORE_FAMILY.get(operand_dtype) == inst.family))


def lower_schedule(schedule, mesh, row_axis: str = "data",
                   col_axis: str = "model", shape=None,
                   overrides: Optional[Mapping[str, Any]] = None,
                   operand_dtype: Optional[str] = None) -> ExecPlan:
    """Resolve a tuned `Schedule` into an `ExecPlan` for `mesh`.

    `schedule` is duck-typed (dataflow / tiling / inner / reduce_owner /
    shape), so core Schedules and deserialized plans both work; `mesh` only
    needs `.shape[axis]` (a real Mesh is required only to materialize the
    view at dispatch). `shape` is the actual problem (GEMMShape or (m, n, k)
    tuple) — it defaults to the schedule's tuned shape but dispatch must
    pass the real operands' shape, which bucketed serving can differ on.
    `overrides` are caller dispatch knobs (currently only `scatter`) merged
    into the mode kwargs *before* legality, so validation sees exactly what
    dispatch will use (the scatter/M drift bug). Geometry is never
    overridable — the mesh view is the schedule's alone, so a caller knob
    cannot diverge from the view it is validated against.
    `operand_dtype` is read on a CUDA mesh only (`card_runs`): the dtype
    the dispatch will launch the product in under the schedule's inner
    kernel (`kernels.ops.tensor_core_dtype`).
    """
    df = getattr(schedule, "dataflow", "summa")
    tiling = getattr(schedule, "tiling", None)
    grid = (int(getattr(tiling, "gm", 1)), int(getattr(tiling, "gn", 1)),
            int(getattr(tiling, "gk", 1)))
    m, n, k = _shape3(shape if shape is not None
                      else getattr(schedule, "shape", None))
    dm, dn = int(mesh.shape[row_axis]), int(mesh.shape[col_axis])

    fallbacks: List[Fallback] = []

    def fall(reason: str, from_mode: str, to_mode: str) -> None:
        fallbacks.append(Fallback(reason, from_mode, to_mode))

    axes: Dict[str, str] = {"row": row_axis, "col": col_axis}
    kwargs: Dict[str, Any] = {}
    view: Optional[MeshView] = None
    # the effective 2-D/3-D grid the chosen mode runs on
    rm, rn, gk = dm, dn, 1

    # -- 1. dataflow mapping + mesh-view construction -----------------------
    if df == "baseline":
        mode = "allgather"
    elif df == "summa":
        mode = "summa"
    elif df == "systolic":
        if dm != dn:
            fall(NON_SQUARE_SYSTOLIC, "cannon", "summa")
            mode = "summa"
        else:
            mode = "cannon"
    elif df in ("systolic_over_summa", "summa_over_systolic"):
        # the two compositions resolve to DISTINCT modes: Fig. 6d
        # (summa_over_systolic) -> hierarchical (outer SUMMA over inner
        # Cannon groups); Fig. 6c (systolic_over_summa) -> outer_systolic
        # (outer Cannon ring of inner SUMMA groups)
        ih, iw = getattr(schedule, "inner", (2, 2))
        want = "outer_systolic" if df == "systolic_over_summa" \
            else "hierarchical"
        if ih != iw:
            fall(NON_SQUARE_INNER, want, "summa")
            mode = "summa"
        elif dm % ih or dn % iw:
            fall(INNER_GRID_MISMATCH, want, "summa")
            mode = "summa"
        else:
            mode = want
            om, on = dm // ih, dn // iw
            if mode == "outer_systolic" and om != on:
                # the Fig. 6c wavefront rotates A/B chunks around outer
                # ppermute rings, which needs a square outer grid; the
                # outer-SUMMA composition handles rectangular grids
                fall(NON_SQUARE_OUTER, "outer_systolic", "hierarchical")
                mode = "hierarchical"
            elif mode == "outer_systolic" and om < 2:
                # a single outer group has no ring to rotate chunks around
                fall(OUTER_RING_TOO_SMALL, "outer_systolic", "hierarchical")
                mode = "hierarchical"
            irow, icol = row_axis + INNER_SUFFIX, col_axis + INNER_SUFFIX
            view = MeshView(splits=(
                (row_axis, ((row_axis, dm // ih), (irow, ih))),
                (col_axis, ((col_axis, dn // iw), (icol, iw)))))
            axes.update(inner_row=irow, inner_col=icol)
            kwargs["inner"] = (ih, iw)
    elif df == "splitk_summa":
        gk = grid[2]
        kwargs["scatter"] = getattr(schedule, "reduce_owner", "") == "round_robin"
        if gk <= 1:
            # a 2-D split-K schedule IS summa (one K-slice owns everything)
            fall(GK_IS_ONE, "splitk_summa", "summa")
            mode = "summa"
            kwargs.pop("scatter")
            gk = 1
        elif dn % gk == 0:
            # factor the k sub-axis out of the column axis, k minor so each
            # k-group's devices stay physically adjacent for the reduction
            mode = "splitk_summa"
            rm, rn = dm, dn // gk
            view = MeshView(splits=(
                (col_axis, ((col_axis, rn), (K_AXIS, gk))),))
            axes["k"] = K_AXIS
        elif dm % gk == 0:
            mode = "splitk_summa"
            rm, rn = dm // gk, dn
            view = MeshView(splits=(
                (row_axis, ((row_axis, rm), (K_AXIS, gk))),))
            axes["k"] = K_AXIS
        else:
            # the tuned k-grid factors into neither physical axis: collapse
            # to 1-D split-K over the column axis — recorded, not silent
            fall(GRID_MISMATCH, "splitk_summa", "splitk")
            mode = "splitk"
            axes["k"] = col_axis
    else:
        fall(UNKNOWN_DATAFLOW, df, "summa")
        mode = "summa"

    if overrides:
        kwargs.update({key: val for key, val in overrides.items()
                       if key in ("scatter",)})

    # -- 2. legality against the actual problem shape -----------------------
    reason = None
    if mode == "summa":
        if m % dm:
            reason = M_NOT_DIVISIBLE
        elif n % dn:
            reason = N_NOT_DIVISIBLE
        elif k % (dm * dn):
            reason = K_NOT_DIVISIBLE
    elif mode in ("cannon", "allgather"):
        if m % dm:
            reason = M_NOT_DIVISIBLE
        elif n % dn:
            reason = N_NOT_DIVISIBLE
        elif k % dm or k % dn:
            reason = K_NOT_DIVISIBLE
    elif mode == "splitk":
        dk = dn if axes["k"] == col_axis else dm
        if k % dk:
            reason = K_NOT_DIVISIBLE
        elif kwargs.get("scatter") and m % dk:
            fall(SCATTER_M_INDIVISIBLE, "splitk", "splitk")
            kwargs["scatter"] = False
    elif mode == "splitk_summa":
        if m % rm:
            reason = M_NOT_DIVISIBLE
        elif n % rn:
            reason = N_NOT_DIVISIBLE
        elif k % (gk * rm * rn):
            reason = K_NOT_DIVISIBLE
        elif kwargs.get("scatter") and m % (rm * gk):
            fall(SCATTER_M_INDIVISIBLE, "splitk_summa", "splitk_summa")
            kwargs["scatter"] = False
    elif mode in ("hierarchical", "outer_systolic"):
        ih = kwargs["inner"][0]
        om, on = dm // ih, dn // ih
        # hierarchical: Om*On outer SUMMA panels, each split into ih Cannon
        # chunks. outer_systolic: Om outer ring chunks (Om == On), each
        # contracted by an ih*ih-panel inner SUMMA.
        kdiv = om * ih * ih if mode == "outer_systolic" else om * on * ih
        if m % dm:
            reason = M_NOT_DIVISIBLE
        elif n % dn:
            reason = N_NOT_DIVISIBLE
        elif k % kdiv:
            reason = K_NOT_DIVISIBLE
    if reason is not None:
        fall(reason, mode, "auto")
        mode, view = "auto", None
        axes, kwargs = {"row": row_axis, "col": col_axis}, {}

    # -- 3. intra-device level: inner kernel + ring/compute overlap ----------
    ik = getattr(schedule, "inner_kernel", None)
    ov = bool(getattr(schedule, "overlap", False))
    if mode == "auto":
        # XLA owns the whole einsum — no inner kernel or ring to overlap;
        # the auto fallback reason above already covers the degradation
        ik, ov = None, False
    elif ik is not None and on_cuda(mesh):
        # the card runs a compiled instance or the route's own geometry,
        # never a geometry swapped at launch
        if not card_runs(ik, m // dm, operand_dtype):
            fall(INNER_KERNEL_NO_INSTANCE, mode, mode)
            ik = None
    elif ik is not None and ik.working_set_bytes() > INNER_VMEM_BUDGET:
        # kwarg-style demotion (mode unchanged): drop to the XLA-picked
        # local GEMM rather than dispatch a kernel that cannot fit VMEM
        fall(INNER_KERNEL_TOO_LARGE, mode, mode)
        ik = None

    return ExecPlan(mode=mode, axes=axes, kwargs=kwargs, view=view,
                    requested=df, grid=grid, shape=(m, n, k),
                    fallbacks=tuple(fallbacks), inner_kernel=ik, overlap=ov)


def lower_attention(schedule, mesh, row_axis: str = "data",
                    col_axis: str = "model", shape=None) -> ExecPlan:
    """Resolve an `AttnSchedule` into an `ExecPlan` for `mesh`.

    Mirrors `lower_schedule`'s contract: duck-typed schedule, namespace
    mesh (only `.shape[axis]` needed), legality checked against the ACTUAL
    problem shape, every degradation recorded. The chain is

        flat_ring --attn_seq_not_divisible--> flat_merge
                  --attn_kv_not_divisible--> unfused_attn

    plus the kwarg demotion `attn_heads_replicated` (heads replicate over
    the column axis instead of sharding; the mode stays fused). The degrade
    target is the explicit `unfused_attn` mode — the legacy
    projections+chunked_sdpa path — never the silent `auto`.
    """
    shp = shape if shape is not None else getattr(schedule, "shape", None)
    if shp is None:
        raise ValueError("lower_attention needs a problem shape: pass "
                         "shape= or a schedule with a .shape")
    dm, dn = int(mesh.shape[row_axis]), int(mesh.shape[col_axis])
    fallbacks: List[Fallback] = []

    def fall(reason: str, from_mode: str, to_mode: str) -> None:
        fallbacks.append(Fallback(reason, from_mode, to_mode))

    comp = getattr(schedule, "composition", "merge")
    if comp not in ("merge", "ring"):
        fall(ATTN_UNKNOWN_COMPOSITION, f"flat_{comp}", "flat_merge")
        comp = "merge"
    mode = "flat_ring" if comp == "ring" else "flat_merge"

    # ring additionally shards Q over the row axis (sq blocks rotate
    # against the KV ring); an indivisible sq — decode's sq=1 on any
    # dm > 1 mesh — demotes to the merge composition, not to unfused
    if mode == "flat_ring" and (dm > 1 and shp.sq % dm):
        fall(ATTN_SEQ_NOT_DIVISIBLE, "flat_ring", "flat_merge")
        mode, comp = "flat_merge", "merge"

    axes: Dict[str, str] = {"row": row_axis, "col": col_axis}
    kwargs: Dict[str, Any] = {}

    # both fused compositions shard KV over the row axis
    if shp.skv % dm:
        fall(ATTN_KV_NOT_DIVISIBLE, mode, "unfused_attn")
        mode = "unfused_attn"
        axes, kwargs = {"row": row_axis, "col": col_axis}, {}
    else:
        # head sharding over the column axis: query heads must divide, and
        # KV heads must either divide too or be fully replicable (MQA /
        # MLA-absorbed, hkv == 1). Otherwise replicate heads — a kwarg
        # demotion (recorded, mode unchanged), exactly like scatter->psum.
        head_shard = (dn > 1 and shp.h % dn == 0
                      and (shp.hkv % dn == 0 or shp.hkv == 1))
        if dn > 1 and not head_shard:
            fall(ATTN_HEADS_REPLICATED, mode, mode)
        kwargs = {"composition": comp, "head_shard": head_shard,
                  "kv_chunk": int(getattr(schedule, "kv_chunk", 256))}

    return ExecPlan(mode=mode, axes=axes, kwargs=kwargs, view=None,
                    requested=getattr(schedule, "dataflow", "flat_attention"),
                    grid=(dm, dn, 1), shape=(shp.sq, shp.skv, shp.h),
                    fallbacks=tuple(fallbacks), inner_kernel=None,
                    overlap=False)


def lowering_summary(plans: Sequence[ExecPlan]) -> Dict[str, Any]:
    """Aggregate counters for a batch of ExecPlans (benchmark / report)."""
    modes: Dict[str, int] = {}
    reasons: Dict[str, int] = {}
    silent = 0
    for ep in plans:
        modes[ep.mode] = modes.get(ep.mode, 0) + 1
        for f in ep.fallbacks:
            reasons[f.reason] = reasons.get(f.reason, 0) + 1
        if ep.mode == "auto" and not ep.fallbacks:
            silent += 1
    return {"modes": modes, "degrade_reasons": reasons,
            "degraded": sum(1 for ep in plans if ep.degraded),
            "silent_auto_degrades": silent, "total": len(plans)}
