"""Split-K dataflow (paper §3.3.2, Fig. 6e + Insight 3).

3-D tiling: the logical grid is (gm x gn x gk); the gk tiles sharing an output
tile process disjoint K-slices concurrently (each slice runs a SUMMA schedule
over its own strided mask groups — 'strided broadcast supported by mask-based
multiple addressing'), then partial C tiles are combined with a hardware NoC
reduction to a configurable owner (§3.1.1 reduction policy) which commits the
result to HBM.

The payoff (Insight 3): for irregular shapes, gk > 1 buys gm/gn small enough
that TM/TN stay matrix-engine-friendly (e.g. N=2112 over gn=4 -> TN=528
instead of TN=66 on a 32x32 2-D mapping).

Mesh-execution analogue: `dit_gemm` mode `splitk` (docs/dataflows.md).
"""
from __future__ import annotations

from typing import List

from repro_torch.core.dataflow.common import GridView
from repro_torch.core.ir import DMAOp, MMADOp, MulticastOp, Program, ReduceOp, Superstep
from repro_torch.core.schedule import Schedule
from repro_torch.hw.config import AcceleratorConfig


def _fetch_and_multicast(g: GridView, om: int, on: int, t: int, slot: int) -> List[object]:
    ops: List[object] = []
    for lk in range(g.gk):
        for lm in range(g.gm):
            owner = g.coord(lm, t % g.gn, lk)
            ops.append(DMAOp(owner, "load", "A", g.a_tile(om, lm, t, lk), "A", slot))
            if g.gn > 1:
                ops.append(MulticastOp(owner, g.row_group(lm, lk), "A", slot,
                                       after_dma=True))
        for ln in range(g.gn):
            owner = g.coord(t % g.gm, ln, lk)
            ops.append(DMAOp(owner, "load", "B", g.b_tile(on, ln, t, lk), "B", slot))
            if g.gm > 1:
                ops.append(MulticastOp(owner, g.col_group(ln, lk), "B", slot,
                                       after_dma=True))
    return ops


def _owner_lk(g: GridView, sched: Schedule, lm: int, ln: int) -> int:
    if sched.reduce_owner == "round_robin":
        return (lm * g.gn + ln) % g.gk
    return 0


def build(sched: Schedule, hw: AcceleratorConfig) -> Program:
    if sched.tiling.gk < 2:
        raise ValueError("splitk_summa requires gk >= 2")
    g = GridView(sched, hw)
    db = sched.double_buffer
    prog = g.make_program(g.std_buffers(), name="splitk_summa")

    for om in range(g.iter_m):
        for on in range(g.iter_n):
            if db:
                prog.add(Superstep(comm=_fetch_and_multicast(g, om, on, 0, 0),
                                   label="pro"))
                for t in range(g.n_ksteps):
                    step = Superstep(label=f"k{t}")
                    for lk in range(g.gk):
                        for lm in range(g.gm):
                            for ln in range(g.gn):
                                step.compute.append(MMADOp(
                                    g.coord(lm, ln, lk), "A", t % 2, "B", t % 2,
                                    "C", 0, init=(t == 0), tm=g.tm, tn=g.tn, tk=g.tk))
                    if t + 1 < g.n_ksteps:
                        step.comm.extend(_fetch_and_multicast(g, om, on, t + 1, (t + 1) % 2))
                    prog.add(step)
            else:
                for t in range(g.n_ksteps):
                    prog.add(Superstep(comm=_fetch_and_multicast(g, om, on, t, 0),
                                       label=f"fetch k{t}"))
                    step = Superstep(label=f"k{t}")
                    for lk in range(g.gk):
                        for lm in range(g.gm):
                            for ln in range(g.gn):
                                step.compute.append(MMADOp(
                                    g.coord(lm, ln, lk), "A", 0, "B", 0, "C", 0,
                                    init=(t == 0), tm=g.tm, tn=g.tn, tk=g.tk))
                    prog.add(step)

            # NoC reduction of partial C over each k-group, then owner commits.
            red = Superstep(label="k-reduce")
            for lm in range(g.gm):
                for ln in range(g.gn):
                    owner = g.coord(lm, ln, _owner_lk(g, sched, lm, ln))
                    red.comm.append(ReduceOp(g.k_group(lm, ln), owner, "C", 0))
            prog.add(red)
            stages = max(1, sched.store_stages)
            stores = [DMAOp(g.coord(lm, ln, _owner_lk(g, sched, lm, ln)),
                            "store", "C", g.c_tile(om, on, lm, ln), "C", 0)
                      for lm in range(g.gm) for ln in range(g.gn)]
            per = (len(stores) + stages - 1) // stages
            for s0 in range(0, len(stores), per):
                prog.add(Superstep(comm=stores[s0:s0 + per], label="store"))
    return prog
