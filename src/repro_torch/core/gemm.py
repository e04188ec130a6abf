"""`dit_gemm` — the paper's dataflow pattern primitives on a device mesh.

Port of `repro/core/gemm.py` for a mesh whose axes all have size 1 (one
H100). Every mode body keeps the reference's structure — SUMMA's panel loop
with masked owner broadcasts, Cannon's skew and rotate loops, split-K's
partial GEMM and reduction, the two hierarchical compositions — and each
per-device contraction goes through `_tile_dot`, i.e. the plan's
`InnerKernel` and the `mmad` kernel. On a 1x1 mesh every collective is the
identity (a sum, gather or ring shift over one rank returns its input) and
every axis index is 0, so those loops run their single step. A mesh with
more than one device raises `NotImplementedError`: the multi-rank modes
arrive with the `torch.distributed` slice of the port.

`auto` is `torch.matmul` with fp32 accumulation — the reference leaves it
to XLA's einsum. Every mode is reverse-differentiable (autograd through the
loops and `local_matmul`'s backward).

Schedule-driven dispatch goes through `repro_torch.core.lower.lower_schedule`,
which resolves the tuned dataflow + logical grid into an `ExecPlan`;
`dit_gemm` consumes the plan.
"""
from __future__ import annotations

import contextlib
import math
from typing import Optional

import torch

from repro_torch.core.lower import ExecPlan, lower_schedule
from repro_torch.core.schedule import InnerKernel

MODES = ("auto", "summa", "cannon", "splitk", "allgather")


def _tile_dot(a: torch.Tensor, b: torch.Tensor,
              kernel: Optional[InnerKernel]) -> torch.Tensor:
    """The per-device contraction every mode body accumulates with, fp32 out.

    `kernel=None` (a plan without an inner kernel, or one demoted for its
    working set) is a plain fp32 product; with a plan-resolved `InnerKernel`
    the contraction runs `kernels.ops.local_matmul` at the planner's block
    geometry and compute dtype — the `mmad` kernel on the card."""
    if kernel is None:
        return torch.matmul(a.float(), b.float())
    from repro_torch.kernels.ops import local_matmul
    return local_matmul(a, b, kernel)


def _axis_size(mesh, name: str) -> int:
    return int(mesh.shape[name])


def _single_device(mesh) -> None:
    """Raise unless every axis of `mesh` has size 1."""
    sizes = {ax: int(mesh.shape[ax]) for ax in mesh.axis_names}
    if math.prod(sizes.values()) != 1:
        raise NotImplementedError(
            f"dit_gemm on a {sizes} mesh needs multi-rank collectives: the "
            f"torch.distributed slice of the port is not written yet "
            f"(ROADMAP.md, queue 1)")


# collectives over one rank: the identity, and every axis index is 0
def _axis_index(mesh, axis: str) -> int:
    assert _axis_size(mesh, axis) == 1
    return 0


def _one_rank(x: torch.Tensor, mesh, axis: str) -> torch.Tensor:
    """psum / all_gather / psum_scatter / ppermute over a size-1 axis."""
    assert _axis_size(mesh, axis) == 1
    return x


def _acc(acc: Optional[torch.Tensor], part: torch.Tensor) -> torch.Tensor:
    """acc + part, where the reference's zero-initialised accumulator is
    elided (0 + x == x, and eager mode would pay a fill and an add)."""
    return part if acc is None else acc + part


def _mode_scope(mode: str):
    """Name every mode's dispatch for the profiler (`dit_gemm.<mode>`).

    A `record_function` costs host time on every dispatch even with no
    profiler running (the reference's named scopes cost nothing per step:
    they are traced once), so the scope is entered only while one is."""
    if torch.autograd.profiler._is_profiler_enabled:
        return torch.profiler.record_function(f"dit_gemm.{mode}")
    return contextlib.nullcontext()


# ---------------------------------------------------------------------------
# SUMMA
# ---------------------------------------------------------------------------

def _summa_acc(a_loc: torch.Tensor, b_loc: torch.Tensor, mesh,
               row_axis: str, col_axis: str, dm: int, dn: int,
               kernel: Optional[InnerKernel] = None) -> torch.Tensor:
    """fp32 SUMMA accumulation of the local C block over dm*dn K-panels,
    each panel owner-broadcast (masked sum) along its axis."""
    panels = dm * dn
    w = a_loc.shape[1] // dm
    i = _axis_index(mesh, row_axis)
    j = _axis_index(mesh, col_axis)
    acc = None
    for p in range(panels):
        # A panel p lives on column p // dm at local offset (p % dm) * w
        a_pan = a_loc[:, (p % dm) * w:(p % dm + 1) * w]
        if j != p // dm:
            a_pan = torch.zeros_like(a_pan)
        a_pan = _one_rank(a_pan, mesh, col_axis)      # owner broadcast
        # B panel p lives on row p // dn at local offset (p % dn) * w
        b_pan = b_loc[(p % dn) * w:(p % dn + 1) * w, :]
        if i != p // dn:
            b_pan = torch.zeros_like(b_pan)
        b_pan = _one_rank(b_pan, mesh, row_axis)      # owner broadcast
        acc = _acc(acc, _tile_dot(a_pan, b_pan, kernel))
    return acc


def summa_gemm(a: torch.Tensor, b: torch.Tensor, mesh,
               row_axis: str = "data", col_axis: str = "model",
               kernel: Optional[InnerKernel] = None) -> torch.Tensor:
    """C[i,j] = sum_p A_panel[i,p] @ B_panel[p,j] with owner broadcasts."""
    _single_device(mesh)
    dm, dn = _axis_size(mesh, row_axis), _axis_size(mesh, col_axis)
    k = a.shape[1]
    panels = dm * dn
    if k % panels:
        raise ValueError(f"K={k} must divide by {panels} SUMMA panels")
    return _summa_acc(a, b, mesh, row_axis, col_axis, dm, dn,
                      kernel).to(a.dtype)


# ---------------------------------------------------------------------------
# Cannon (systolic)
# ---------------------------------------------------------------------------

def _cannon_acc(a_blk: torch.Tensor, b_blk: torch.Tensor, mesh,
                row_axis: str, col_axis: str, d: int,
                kernel: Optional[InnerKernel] = None,
                overlap: bool = False) -> torch.Tensor:
    """fp32 Cannon accumulation on a square d x d (sub-)grid: initial skew,
    then d rotate-and-accumulate steps. `overlap=True` issues step s+1's
    ring hops before consuming step s's blocks (numerically identical)."""
    i = _axis_index(mesh, row_axis)
    j = _axis_index(mesh, col_axis)
    a_cur, b_cur = a_blk, b_blk
    for s in range(d - 1):                       # initial skew
        shifted = _one_rank(a_cur, mesh, col_axis)
        a_cur = shifted if i > s else a_cur
    for s in range(d - 1):
        shifted = _one_rank(b_cur, mesh, row_axis)
        b_cur = shifted if j > s else b_cur
    acc = None
    for _ in range(d):                           # rotate and accumulate
        if overlap:
            a_nxt = _one_rank(a_cur, mesh, col_axis)
            b_nxt = _one_rank(b_cur, mesh, row_axis)
            acc = _acc(acc, _tile_dot(a_cur, b_cur, kernel))
            a_cur, b_cur = a_nxt, b_nxt
        else:
            acc = _acc(acc, _tile_dot(a_cur, b_cur, kernel))
            a_cur = _one_rank(a_cur, mesh, col_axis)
            b_cur = _one_rank(b_cur, mesh, row_axis)
    return acc


def cannon_gemm(a: torch.Tensor, b: torch.Tensor, mesh,
                row_axis: str = "data", col_axis: str = "model",
                kernel: Optional[InnerKernel] = None,
                overlap: bool = False) -> torch.Tensor:
    """Systolic GEMM on a square mesh: skew, then rotate-and-accumulate."""
    _single_device(mesh)
    dm, dn = _axis_size(mesh, row_axis), _axis_size(mesh, col_axis)
    if dm != dn:
        raise ValueError(f"cannon needs a square mesh, got {dm}x{dn}")
    return _cannon_acc(a, b, mesh, row_axis, col_axis, dm, kernel,
                       overlap).to(a.dtype)


# ---------------------------------------------------------------------------
# Split-K (1-D and the schedule's 3-D grid)
# ---------------------------------------------------------------------------

def splitk_gemm(a: torch.Tensor, b: torch.Tensor, mesh,
                k_axis: str = "model", scatter: bool = True,
                kernel: Optional[InnerKernel] = None) -> torch.Tensor:
    """K sharded over `k_axis`; local partial GEMM + reduction (reduce-
    scatter of C row-blocks with `scatter`, else an all-reduce)."""
    _single_device(mesh)
    dk = _axis_size(mesh, k_axis)
    m = a.shape[0]
    if scatter and m % dk:
        raise ValueError(f"M={m} must divide by k-axis size {dk} for scatter")
    part = _tile_dot(a, b, kernel)
    return _one_rank(part, mesh, k_axis).to(a.dtype)


def splitk_summa_gemm(a: torch.Tensor, b: torch.Tensor, mesh,
                      row_axis: str = "data", col_axis: str = "model",
                      k_axis: str = "splitk", scatter: bool = True,
                      kernel: Optional[InnerKernel] = None) -> torch.Tensor:
    """3-D split-K on a (row x col x k) mesh view: each k-group runs SUMMA
    on its K slice, then partials reduce over the k sub-axis."""
    _single_device(mesh)
    rm, rn = _axis_size(mesh, row_axis), _axis_size(mesh, col_axis)
    gk = _axis_size(mesh, k_axis)
    m, k = a.shape
    if k % (gk * rm * rn):
        raise ValueError(f"K={k} must divide by gk*rm*rn={gk * rm * rn}")
    if scatter and m % (rm * gk):
        raise ValueError(f"M={m} must divide by rm*gk={rm * gk} for scatter")
    acc = _summa_acc(a, b, mesh, row_axis, col_axis, rm, rn, kernel)
    return _one_rank(acc, mesh, k_axis).to(a.dtype)


# ---------------------------------------------------------------------------
# Hierarchical: outer SUMMA over inner Cannon groups (Fig. 6d)
# ---------------------------------------------------------------------------

def hierarchical_gemm(a: torch.Tensor, b: torch.Tensor, mesh,
                      row_axis: str = "data", col_axis: str = "model",
                      inner_row: str = "data_in",
                      inner_col: str = "model_in",
                      kernel: Optional[InnerKernel] = None,
                      overlap: bool = False) -> torch.Tensor:
    """Outer (Om x On) SUMMA over inner (ih x ih) Cannon groups."""
    _single_device(mesh)
    om, ih = _axis_size(mesh, row_axis), _axis_size(mesh, inner_row)
    on, iw = _axis_size(mesh, col_axis), _axis_size(mesh, inner_col)
    if ih != iw:
        raise ValueError(f"hierarchical needs square inner groups, got {ih}x{iw}")
    k = a.shape[1]
    if k % (om * on * ih):
        raise ValueError(f"K={k} must divide by Om*On*ih={om * on * ih}")
    wo = k // (om * on)          # outer K-panel width (per group)
    wk = wo // ih                # inner Cannon block width
    oi, oj = _axis_index(mesh, row_axis), _axis_index(mesh, col_axis)
    li, lj = _axis_index(mesh, inner_row), _axis_index(mesh, inner_col)
    a_g = _one_rank(a, mesh, inner_col)          # gather the group's K range
    b_g = _one_rank(b, mesh, inner_row)
    acc = None
    for p in range(om * on):
        off = (p % om) * wo + lj * wk
        a_pan = a_g[:, off:off + wk]
        if oj != p // om:
            a_pan = torch.zeros_like(a_pan)
        a_pan = _one_rank(a_pan, mesh, col_axis)     # group broadcast
        off = (p % on) * wo + li * wk
        b_pan = b_g[off:off + wk, :]
        if oi != p // on:
            b_pan = torch.zeros_like(b_pan)
        b_pan = _one_rank(b_pan, mesh, row_axis)     # group broadcast
        acc = _acc(acc, _cannon_acc(a_pan, b_pan, mesh, inner_row,
                                    inner_col, ih, kernel, overlap))
    return acc.to(a.dtype)


# ---------------------------------------------------------------------------
# Outer-systolic: outer Cannon ring of inner SUMMA groups (Fig. 6c)
# ---------------------------------------------------------------------------

def outer_systolic_gemm(a: torch.Tensor, b: torch.Tensor, mesh,
                        row_axis: str = "data", col_axis: str = "model",
                        inner_row: str = "data_in",
                        inner_col: str = "model_in",
                        kernel: Optional[InnerKernel] = None,
                        overlap: bool = False) -> torch.Tensor:
    """Outer Cannon ring over inner (ih x ih) SUMMA groups."""
    _single_device(mesh)
    om, ih = _axis_size(mesh, row_axis), _axis_size(mesh, inner_row)
    on, iw = _axis_size(mesh, col_axis), _axis_size(mesh, inner_col)
    if ih != iw:
        raise ValueError(f"outer_systolic needs square inner groups, "
                         f"got {ih}x{iw}")
    if om != on:
        raise ValueError(f"outer_systolic needs a square outer grid, "
                         f"got {om}x{on}")
    k = a.shape[1]
    if k % (om * ih * ih):
        raise ValueError(f"K={k} must divide by Om*ih^2={om * ih * ih}")
    d = om
    oi, oj = _axis_index(mesh, row_axis), _axis_index(mesh, col_axis)
    a_cur, b_cur = a, b
    for s in range(d - 1):                       # group-level skew
        shifted = _one_rank(a_cur, mesh, col_axis)
        a_cur = shifted if oi > s else a_cur
    for s in range(d - 1):
        shifted = _one_rank(b_cur, mesh, row_axis)
        b_cur = shifted if oj > s else b_cur
    acc = None
    for _ in range(d):
        if overlap:
            a_nxt = _one_rank(a_cur, mesh, col_axis)
            b_nxt = _one_rank(b_cur, mesh, row_axis)
            acc = _acc(acc, _summa_acc(a_cur, b_cur, mesh, inner_row,
                                       inner_col, ih, ih, kernel))
            a_cur, b_cur = a_nxt, b_nxt
        else:
            acc = _acc(acc, _summa_acc(a_cur, b_cur, mesh, inner_row,
                                       inner_col, ih, ih, kernel))
            a_cur = _one_rank(a_cur, mesh, col_axis)     # chunk west
            b_cur = _one_rank(b_cur, mesh, row_axis)     # chunk north
    return acc.to(a.dtype)


# ---------------------------------------------------------------------------
# All-gather baseline + auto
# ---------------------------------------------------------------------------

def allgather_gemm(a: torch.Tensor, b: torch.Tensor, mesh,
                   row_axis: str = "data", col_axis: str = "model",
                   kernel: Optional[InnerKernel] = None) -> torch.Tensor:
    """Gather A's panels along cols / B's along rows once, then one local GEMM."""
    _single_device(mesh)
    a_full = _one_rank(a, mesh, col_axis)
    b_full = _one_rank(b, mesh, row_axis)
    return _tile_dot(a_full, b_full, kernel).to(a.dtype)


def auto_gemm(a: torch.Tensor, b: torch.Tensor, mesh,
              row_axis: str = "data", col_axis: str = "model") -> torch.Tensor:
    """Plain fp32-accumulated product: the reference's XLA einsum."""
    _single_device(mesh)
    return torch.matmul(a.float(), b.float()).to(a.dtype)


# ---------------------------------------------------------------------------
# ExecPlan dispatch
# ---------------------------------------------------------------------------

def exec_plan_gemm(a: torch.Tensor, b: torch.Tensor, mesh,
                   exec_plan: ExecPlan) -> torch.Tensor:
    """Run one 2-D GEMM exactly as a resolved `ExecPlan` prescribes."""
    ax = exec_plan.axes
    emesh = (exec_plan.view.materialize(mesh) if exec_plan.view is not None
             else mesh)
    mode = exec_plan.mode
    ik = exec_plan.inner_kernel
    ov = exec_plan.overlap
    with _mode_scope(mode):
        if mode == "auto":
            return auto_gemm(a, b, mesh, ax["row"], ax["col"])
        if mode == "summa":
            return summa_gemm(a, b, emesh, ax["row"], ax["col"], kernel=ik)
        if mode == "cannon":
            return cannon_gemm(a, b, emesh, ax["row"], ax["col"],
                               kernel=ik, overlap=ov)
        if mode == "allgather":
            return allgather_gemm(a, b, emesh, ax["row"], ax["col"],
                                  kernel=ik)
        if mode == "splitk":
            return splitk_gemm(a, b, emesh, k_axis=ax["k"],
                               scatter=exec_plan.kwargs.get("scatter", True),
                               kernel=ik)
        if mode == "splitk_summa":
            return splitk_summa_gemm(
                a, b, emesh, ax["row"], ax["col"], ax["k"],
                scatter=exec_plan.kwargs.get("scatter", True), kernel=ik)
        if mode == "hierarchical":
            return hierarchical_gemm(a, b, emesh, ax["row"], ax["col"],
                                     ax["inner_row"], ax["inner_col"],
                                     kernel=ik, overlap=ov)
        if mode == "outer_systolic":
            return outer_systolic_gemm(a, b, emesh, ax["row"], ax["col"],
                                       ax["inner_row"], ax["inner_col"],
                                       kernel=ik, overlap=ov)
    raise KeyError(f"ExecPlan resolved to unknown mode {mode!r}")


def dit_gemm(a: torch.Tensor, b: torch.Tensor, mesh, mode: str = "auto",
             row_axis: str = "data", col_axis: str = "model",
             plan=None, planner=None, exec_plan: Optional[ExecPlan] = None,
             **kw) -> torch.Tensor:
    """Dispatch on the deployment schedule's dataflow pattern.

    Three override layers, strongest first: a pre-resolved `exec_plan`;
    a `plan` (DeploymentPlan or bare Schedule) or `planner`, lowered here
    against the actual operand shapes (caller `**kw` knobs such as
    `scatter` merge before legality); `mode` + `**kw` for direct dispatch
    of one of `MODES`.

    `a` may carry leading batch/seq dims (B, S, K): they flatten into M and
    the result is reshaped back to (B, S, N). `b` must be 2-D (K, N).
    """
    if b.dim() != 2:
        raise ValueError(f"dit_gemm expects a 2-D weight, got {tuple(b.shape)}")
    lead = a.shape[:-1]
    if a.dim() != 2:
        a = a.reshape(-1, a.shape[-1])
    if planner is not None and plan is None:
        from repro_torch.core.schedule import GEMMShape
        plan = planner.plan(GEMMShape(a.shape[0], b.shape[1], a.shape[1]))
    if exec_plan is None and plan is not None:
        sched = getattr(plan, "schedule", plan)
        exec_plan = lower_schedule(sched, mesh, row_axis, col_axis,
                                   shape=(a.shape[0], b.shape[1], a.shape[1]),
                                   overrides=kw)
    if exec_plan is not None:
        out = exec_plan_gemm(a, b, mesh, exec_plan)
    elif mode not in MODES:
        raise KeyError(f"unknown mode {mode!r}; have {MODES}")
    else:
        with _mode_scope(mode):
            if mode == "auto":
                out = auto_gemm(a, b, mesh, row_axis, col_axis)
            elif mode == "summa":
                out = summa_gemm(a, b, mesh, row_axis, col_axis)
            elif mode == "cannon":
                out = cannon_gemm(a, b, mesh, row_axis, col_axis)
            elif mode == "splitk":
                out = splitk_gemm(a, b, mesh,
                                  k_axis=kw.get("k_axis", col_axis),
                                  scatter=kw.get("scatter", True))
            else:
                out = allgather_gemm(a, b, mesh, row_axis, col_axis)
    if len(lead) != 1:
        out = out.reshape(*lead, b.shape[1])
    return out
