"""`dit_gemm` — the paper's dataflow pattern primitives on a device mesh.

Port of `repro/core/gemm.py`. The reference runs each mode body inside
`shard_map` with `jax.lax` collectives; here the body runs on every rank of
the mesh with the collectives of `core/collectives.py` over
`torch.distributed` process groups. The tensor contract is the port's
counterpart of a jax global array: the operands arrive whole on every
rank, each rank takes its block by its coordinates as the reference's
`in_specs` say (`shard`), runs the body, and the out spec's blocks are
gathered (`unshard`), so every rank returns the same global C. Every
per-device contraction goes through `_tile_dot`, i.e. the plan's
`InnerKernel` and the `mmad` kernel.

- **summa**: K-panel loop; each panel is owner-broadcast along its axis as
  a `psum` of the masked operand, then accumulated into the local C block.
- **cannon**: initial skew, then rotate A west and B north with `ppermute`
  rings and accumulate. `overlap=True` posts step s+1's sends and
  receives before step s's tile compute and waits on them after.
- **splitk**: K sharded; local partial GEMM then `psum_scatter` (scatter)
  or `psum` (a replicated C).
- **splitk_summa**, **hierarchical**, **outer_systolic**: the 3-D split-K
  and the two hierarchical compositions on a `MeshView`'s sub-axes.
- **allgather**: gather all panels once, one local GEMM.
- **auto**: `torch.matmul` with fp32 accumulation on every rank — the
  reference leaves it to XLA's einsum.

On the one-card 1x1 mesh every axis has size 1: every collective, `shard`
and `unshard` is the identity and nothing is launched for them, so those
loops run their single step. Rank-dependent choices go through
`collectives.pick` only where an axis has more than one rank, so every
rank issues the same collectives, backward included. Every mode is
reverse-differentiable (autograd through the loops, the collectives'
transposes and `local_matmul`'s backward).

Schedule-driven dispatch goes through `repro_torch.core.lower.lower_schedule`,
which resolves the tuned dataflow + logical grid into an `ExecPlan`;
`dit_gemm` consumes the plan.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.core.collectives import (all_gather, axis_index,
                                          axis_size as _axis_size, pick,
                                          ppermute, ppermute_start, psum,
                                          psum_scatter, shard, unshard)
from repro_torch.core.lower import ExecPlan, lower_schedule, on_cuda
from repro_torch.core.schedule import InnerKernel
from repro_torch.kernels.ops import cast_c, local_matmul
from repro_torch.obs.trace import profile_scope

MODES = ("auto", "summa", "cannon", "splitk", "allgather")


def _tile_dot(a: torch.Tensor, b: torch.Tensor,
              kernel: Optional[InnerKernel]) -> torch.Tensor:
    """The per-device contraction every mode body accumulates with, fp32 out:
    `kernels.ops.local_matmul`, the `mmad` kernel on the card, in the
    plan-resolved `InnerKernel`'s compute dtype and at its CTA tile, K step
    and ring depth (a tensor-core instance: lowering on a CUDA mesh demotes
    any other kernel, `inner_kernel_no_instance`). With `kernel=None` (a
    plan without an inner kernel, or one demoted) the reference lets XLA
    pick the local GEMM; here `mmad` still runs it, at the geometry its
    route picks (the tensor cores' own tile, a stream kernel or the SIMT
    tile route), and CPU tensors take the same fp32 product as the
    reference's `jnp.dot`."""
    return local_matmul(a, b, kernel)


def _acc(acc: Optional[torch.Tensor], part: torch.Tensor) -> torch.Tensor:
    """acc + part, where the reference's zero-initialised accumulator is
    elided (0 + x == x, and eager mode would pay a fill and an add)."""
    return part if acc is None else acc + part


def _owned(x: torch.Tensor, mesh, axis: str, owner: bool) -> torch.Tensor:
    """`x` on the owner of a broadcast along `axis`, zeros elsewhere (the
    masked operand the owner-broadcast `psum` sums)."""
    if _axis_size(mesh, axis) == 1:
        return x
    return pick(owner, x, torch.zeros_like(x))


def _ring(d: int):
    """The one-hop ring shift: axis index s sends to s - 1."""
    return [(s, (s - 1) % d) for s in range(d)]


def _skew(x: torch.Tensor, mesh, axis: str, by: int, d: int) -> torch.Tensor:
    """Cannon's initial skew: `by` hops along `axis`'s ring. Every rank
    runs the same d - 1 hops and keeps the first `by` of them."""
    for s in range(d - 1):
        x = pick(by > s, ppermute(x, mesh, axis, _ring(d)), x)
    return x


def _sharded(body, a: torch.Tensor, b: torch.Tensor, mesh, a_spec, b_spec,
             c_spec) -> torch.Tensor:
    """Run `body` on this rank's blocks of A and B (the reference's
    `in_specs`) and gather its C blocks by `c_spec` into the global C."""
    c = body(shard(a, mesh, a_spec), shard(b, mesh, b_spec))
    return unshard(c, mesh, c_spec, (a.shape[0], b.shape[1]))


# ---------------------------------------------------------------------------
# SUMMA
# ---------------------------------------------------------------------------

def _summa_acc(a_loc: torch.Tensor, b_loc: torch.Tensor, mesh,
               row_axis: str, col_axis: str, dm: int, dn: int,
               kernel: Optional[InnerKernel] = None) -> torch.Tensor:
    """fp32 SUMMA accumulation of the local C block over dm*dn K-panels,
    each panel owner-broadcast (masked sum) along its axis. The axes may be
    sub-axes of a mesh view; the broadcasts then stay within the group."""
    panels = dm * dn
    w = a_loc.shape[1] // dm
    i = axis_index(mesh, row_axis)
    j = axis_index(mesh, col_axis)
    acc = None
    for p in range(panels):
        # A panel p lives on column p // dm at local offset (p % dm) * w
        a_pan = a_loc[:, (p % dm) * w:(p % dm + 1) * w]
        a_pan = psum(_owned(a_pan, mesh, col_axis, j == p // dm), mesh,
                     col_axis)                          # owner broadcast
        # B panel p lives on row p // dn at local offset (p % dn) * w
        b_pan = b_loc[(p % dn) * w:(p % dn + 1) * w, :]
        b_pan = psum(_owned(b_pan, mesh, row_axis, i == p // dn), mesh,
                     row_axis)                          # owner broadcast
        acc = _acc(acc, _tile_dot(a_pan, b_pan, kernel))
    return acc


def summa_gemm(a: torch.Tensor, b: torch.Tensor, mesh,
               row_axis: str = "data", col_axis: str = "model",
               kernel: Optional[InnerKernel] = None) -> torch.Tensor:
    """C[i,j] = sum_p A_panel[i,p] @ B_panel[p,j] with owner broadcasts.
    A, B and C are sharded (row_axis, col_axis)."""
    dm, dn = _axis_size(mesh, row_axis), _axis_size(mesh, col_axis)
    k = a.shape[1]
    panels = dm * dn
    if k % panels:
        raise ValueError(f"K={k} must divide by {panels} SUMMA panels")

    def body(a_loc, b_loc):
        return cast_c(_summa_acc(a_loc, b_loc, mesh, row_axis, col_axis,
                                 dm, dn, kernel), a.dtype)

    spec = (row_axis, col_axis)
    return _sharded(body, a, b, mesh, spec, spec, spec)


# ---------------------------------------------------------------------------
# Cannon (systolic)
# ---------------------------------------------------------------------------

def _cannon_acc(a_blk: torch.Tensor, b_blk: torch.Tensor, mesh,
                row_axis: str, col_axis: str, d: int,
                kernel: Optional[InnerKernel] = None,
                overlap: bool = False) -> torch.Tensor:
    """fp32 Cannon accumulation on a square d x d (sub-)grid: initial skew
    (A block (i, j) -> (i, j - i), B block (i, j) -> (i - j, j)), then d
    rotate-and-accumulate steps. `overlap=True` posts step s+1's ring hops
    before consuming step s's blocks and waits on them after (numerically
    identical). The last step's rotation, which nothing reads, is not
    sent."""
    i = axis_index(mesh, row_axis)
    j = axis_index(mesh, col_axis)
    a_cur = _skew(a_blk, mesh, col_axis, i, d)
    b_cur = _skew(b_blk, mesh, row_axis, j, d)
    acc = None
    for s in range(d):
        last = s == d - 1
        if overlap and not last:
            a_nxt = ppermute_start(a_cur, mesh, col_axis, _ring(d))
            b_nxt = ppermute_start(b_cur, mesh, row_axis, _ring(d))
            acc = _acc(acc, _tile_dot(a_cur, b_cur, kernel))
            a_cur, b_cur = a_nxt.wait(), b_nxt.wait()
        else:
            acc = _acc(acc, _tile_dot(a_cur, b_cur, kernel))
            if not last:
                a_cur = ppermute(a_cur, mesh, col_axis, _ring(d))
                b_cur = ppermute(b_cur, mesh, row_axis, _ring(d))
    return acc


def cannon_gemm(a: torch.Tensor, b: torch.Tensor, mesh,
                row_axis: str = "data", col_axis: str = "model",
                kernel: Optional[InnerKernel] = None,
                overlap: bool = False) -> torch.Tensor:
    """Systolic GEMM on a square mesh: skew, then rotate-and-accumulate."""
    dm, dn = _axis_size(mesh, row_axis), _axis_size(mesh, col_axis)
    if dm != dn:
        raise ValueError(f"cannon needs a square mesh, got {dm}x{dn}")

    def body(a_loc, b_loc):
        return cast_c(_cannon_acc(a_loc, b_loc, mesh, row_axis, col_axis,
                                  dm, kernel, overlap), a.dtype)

    spec = (row_axis, col_axis)
    return _sharded(body, a, b, mesh, spec, spec, spec)


# ---------------------------------------------------------------------------
# Split-K (1-D and the schedule's 3-D grid)
# ---------------------------------------------------------------------------

def _reduce_k(part: torch.Tensor, mesh, k_axis: str,
              scatter: bool) -> torch.Tensor:
    """Reduce K partials over `k_axis`: C row-blocks round-robined over the
    k-group (scatter), or a C replicated over it."""
    if scatter:
        return psum_scatter(part, mesh, k_axis, 0)
    return psum(part, mesh, k_axis)


def splitk_gemm(a: torch.Tensor, b: torch.Tensor, mesh,
                k_axis: str = "model", scatter: bool = True,
                kernel: Optional[InnerKernel] = None) -> torch.Tensor:
    """K sharded over `k_axis`; local partial GEMM + reduction (reduce-
    scatter of C row-blocks with `scatter`, else an all-reduce)."""
    dk = _axis_size(mesh, k_axis)
    m = a.shape[0]
    if scatter and m % dk:
        raise ValueError(f"M={m} must divide by k-axis size {dk} for scatter")

    def body(a_loc, b_loc):
        return cast_c(_reduce_k(_tile_dot(a_loc, b_loc, kernel), mesh,
                                k_axis, scatter), a.dtype)

    return _sharded(body, a, b, mesh, (None, k_axis), (k_axis, None),
                    (k_axis, None) if scatter else (None, None))


def splitk_summa_gemm(a: torch.Tensor, b: torch.Tensor, mesh,
                      row_axis: str = "data", col_axis: str = "model",
                      k_axis: str = "splitk", scatter: bool = True,
                      kernel: Optional[InnerKernel] = None) -> torch.Tensor:
    """3-D split-K on a (row x col x k) mesh view: each k-group runs SUMMA
    on its K slice, then partials reduce over the k sub-axis. A is sharded
    (row, (k, col)), B ((k, row), col); C ((row, k), col) with `scatter`,
    else (row, col)."""
    rm, rn = _axis_size(mesh, row_axis), _axis_size(mesh, col_axis)
    gk = _axis_size(mesh, k_axis)
    m, k = a.shape
    if k % (gk * rm * rn):
        raise ValueError(f"K={k} must divide by gk*rm*rn={gk * rm * rn}")
    if scatter and m % (rm * gk):
        raise ValueError(f"M={m} must divide by rm*gk={rm * gk} for scatter")

    def body(a_loc, b_loc):
        acc = _summa_acc(a_loc, b_loc, mesh, row_axis, col_axis, rm, rn,
                         kernel)
        return cast_c(_reduce_k(acc, mesh, k_axis, scatter), a.dtype)

    return _sharded(body, a, b, mesh, (row_axis, (k_axis, col_axis)),
                    ((k_axis, row_axis), col_axis),
                    ((row_axis, k_axis), col_axis) if scatter
                    else (row_axis, col_axis))


# ---------------------------------------------------------------------------
# Hierarchical: outer SUMMA over inner Cannon groups (Fig. 6d)
# ---------------------------------------------------------------------------

def hierarchical_gemm(a: torch.Tensor, b: torch.Tensor, mesh,
                      row_axis: str = "data", col_axis: str = "model",
                      inner_row: str = "data_in",
                      inner_col: str = "model_in",
                      kernel: Optional[InnerKernel] = None,
                      overlap: bool = False) -> torch.Tensor:
    """Outer (Om x On) SUMMA over inner (ih x ih) Cannon groups, on an
    (outer_row x inner_row x outer_col x inner_col) mesh view."""
    om, ih = _axis_size(mesh, row_axis), _axis_size(mesh, inner_row)
    on, iw = _axis_size(mesh, col_axis), _axis_size(mesh, inner_col)
    if ih != iw:
        raise ValueError(f"hierarchical needs square inner groups, got {ih}x{iw}")
    k = a.shape[1]
    if k % (om * on * ih):
        raise ValueError(f"K={k} must divide by Om*On*ih={om * on * ih}")
    wo = k // (om * on)          # outer K-panel width (per group)
    wk = wo // ih                # inner Cannon block width

    def body(a_loc, b_loc):
        oi, oj = axis_index(mesh, row_axis), axis_index(mesh, col_axis)
        li, lj = axis_index(mesh, inner_row), axis_index(mesh, inner_col)
        # reassemble each group's contiguous K range so any outer panel
        # can be sliced uniformly
        a_g = all_gather(a_loc, mesh, inner_col, 1)
        b_g = all_gather(b_loc, mesh, inner_row, 0)
        acc = None
        for p in range(om * on):
            off = (p % om) * wo + lj * wk
            a_pan = psum(_owned(a_g[:, off:off + wk], mesh, col_axis,
                                oj == p // om), mesh, col_axis)
            off = (p % on) * wo + li * wk
            b_pan = psum(_owned(b_g[off:off + wk, :], mesh, row_axis,
                                oi == p // on), mesh, row_axis)
            acc = _acc(acc, _cannon_acc(a_pan, b_pan, mesh, inner_row,
                                        inner_col, ih, kernel, overlap))
        return cast_c(acc, a.dtype)

    spec = ((row_axis, inner_row), (col_axis, inner_col))
    return _sharded(body, a, b, mesh, spec, spec, spec)


# ---------------------------------------------------------------------------
# Outer-systolic: outer Cannon ring of inner SUMMA groups (Fig. 6c)
# ---------------------------------------------------------------------------

def outer_systolic_gemm(a: torch.Tensor, b: torch.Tensor, mesh,
                        row_axis: str = "data", col_axis: str = "model",
                        inner_row: str = "data_in",
                        inner_col: str = "model_in",
                        kernel: Optional[InnerKernel] = None,
                        overlap: bool = False) -> torch.Tensor:
    """Outer Cannon ring over inner (ih x ih) SUMMA groups: the group-level
    skew and rotations are ring hops over the outer axes, each inner group
    contracts its chunk with `_summa_acc`."""
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

    def body(a_loc, b_loc):
        oi, oj = axis_index(mesh, row_axis), axis_index(mesh, col_axis)
        a_cur = _skew(a_loc, mesh, col_axis, oi, d)      # group-level skew
        b_cur = _skew(b_loc, mesh, row_axis, oj, d)
        acc = None
        for s in range(d):
            last = s == d - 1
            if overlap and not last:
                a_nxt = ppermute_start(a_cur, mesh, col_axis, _ring(d))
                b_nxt = ppermute_start(b_cur, mesh, row_axis, _ring(d))
                acc = _acc(acc, _summa_acc(a_cur, b_cur, mesh, inner_row,
                                           inner_col, ih, ih, kernel))
                a_cur, b_cur = a_nxt.wait(), b_nxt.wait()
            else:
                acc = _acc(acc, _summa_acc(a_cur, b_cur, mesh, inner_row,
                                           inner_col, ih, ih, kernel))
                if not last:
                    a_cur = ppermute(a_cur, mesh, col_axis, _ring(d))  # west
                    b_cur = ppermute(b_cur, mesh, row_axis, _ring(d))  # north
        return cast_c(acc, a.dtype)

    spec = ((row_axis, inner_row), (col_axis, inner_col))
    return _sharded(body, a, b, mesh, spec, spec, spec)


# ---------------------------------------------------------------------------
# All-gather baseline + auto
# ---------------------------------------------------------------------------

def allgather_gemm(a: torch.Tensor, b: torch.Tensor, mesh,
                   row_axis: str = "data", col_axis: str = "model",
                   kernel: Optional[InnerKernel] = None) -> torch.Tensor:
    """Gather A's panels along cols / B's along rows once, then one local GEMM."""
    def body(a_loc, b_loc):
        a_full = all_gather(a_loc, mesh, col_axis, 1)
        b_full = all_gather(b_loc, mesh, row_axis, 0)
        return cast_c(_tile_dot(a_full, b_full, kernel), a.dtype)

    spec = (row_axis, col_axis)
    return _sharded(body, a, b, mesh, spec, spec, spec)


def auto_gemm(a: torch.Tensor, b: torch.Tensor, mesh,
              row_axis: str = "data", col_axis: str = "model") -> torch.Tensor:
    """Plain fp32-accumulated product: the reference's XLA einsum. Every
    rank holds the operands whole, so each computes C whole."""
    return cast_c(torch.matmul(a.float(), b.float()), a.dtype)


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
    with profile_scope(f"dit_gemm.{mode}"):
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


def lower_for(sched, mesh, a: torch.Tensor, b: torch.Tensor,
              row_axis: str = "data", col_axis: str = "model",
              overrides=None) -> ExecPlan:
    """`lower_schedule` for the product of a (M, K) and b (K, N) as the
    dispatch will run it: on a CUDA mesh with the dtype of the tensor-core
    launch it would take under the schedule's inner kernel
    (`kernels.ops.tensor_core_dtype`), so a kernel the card cannot run on
    these operands is demoted here, by name."""
    operand_dtype = None
    if on_cuda(mesh):
        from repro_torch.kernels.ops import tensor_core_dtype
        operand_dtype = tensor_core_dtype(
            getattr(sched, "inner_kernel", None), a, b)
    return lower_schedule(sched, mesh, row_axis, col_axis,
                          shape=(a.shape[0], b.shape[1], a.shape[1]),
                          overrides=overrides, operand_dtype=operand_dtype)


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
    if planner is not None or plan is not None:
        with profile_scope("gemm.resolve"):
            if planner is not None and plan is None:
                from repro_torch.core.schedule import GEMMShape
                plan = planner.plan(GEMMShape(a.shape[0], b.shape[1],
                                              a.shape[1]))
            if exec_plan is None and plan is not None:
                exec_plan = lower_for(getattr(plan, "schedule", plan), mesh,
                                      a, b, row_axis, col_axis, overrides=kw)
    if exec_plan is not None:
        out = exec_plan_gemm(a, b, mesh, exec_plan)
    elif mode not in MODES:
        raise KeyError(f"unknown mode {mode!r}; have {MODES}")
    else:
        with profile_scope(f"dit_gemm.{mode}"):
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
