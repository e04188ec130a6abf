"""SUMMA dataflow (paper §3.3.2, Fig. 6a).

Classical SUMMA adapted to a machine whose data starts in distributed HBM:
each k-step, one owner tile per logical row DMA-loads the A tile and the
fabric multicast chains straight off the DMA (same superstep, `after_dma`) to
the whole row; one owner per logical column does the same for B. All tiles
then MMAD simultaneously — no wavefront, which is why SUMMA wins compute-bound
shapes (Fig. 8a) but suffers store bursts in store-bound shapes (Fig. 8b),
where `store_stages > 1` pipelines the C write-back into the next iteration's
compute supersteps.

Double-buffered pipeline (§3.3.1): superstep s computes chunk t from working
slot (t%2) while owners DMA-load + multicast chunk t+1 into slot ((t+1)%2) —
two slots per operand buffer, no separate staging.

Mesh-execution analogue: `dit_gemm` mode `summa` (docs/dataflows.md).
"""
from __future__ import annotations

from typing import List

from repro_torch.core.dataflow.common import GridView
from repro_torch.core.ir import DMAOp, MMADOp, MulticastOp, Program, Superstep
from repro_torch.core.schedule import Schedule
from repro_torch.hw.config import AcceleratorConfig


def _fetch_and_multicast(g: GridView, om: int, on: int, t: int, slot: int) -> List[object]:
    """Owner DMA load of k-chunk t + chained row/col multicast (one superstep)."""
    ops: List[object] = []
    for lm in range(g.gm):
        owner = g.coord(lm, t % g.gn)
        ops.append(DMAOp(owner, "load", "A", g.a_tile(om, lm, t), "A", slot))
        ops.append(MulticastOp(owner, g.row_group(lm), "A", slot, after_dma=True))
    for ln in range(g.gn):
        owner = g.coord(t % g.gm, ln)
        ops.append(DMAOp(owner, "load", "B", g.b_tile(on, ln, t), "B", slot))
        ops.append(MulticastOp(owner, g.col_group(ln), "B", slot, after_dma=True))
    return ops


def _stores(g: GridView, om: int, on: int, acc_slot: int) -> List[DMAOp]:
    return [DMAOp(g.coord(lm, ln), "store", "C", g.c_tile(om, on, lm, ln), "C", acc_slot)
            for lm in range(g.gm) for ln in range(g.gn)]


def build(sched: Schedule, hw: AcceleratorConfig) -> Program:
    if sched.tiling.gk != 1:
        raise ValueError("summa dataflow is 2-D; use splitk_summa for gk > 1")
    g = GridView(sched, hw)
    db = sched.double_buffer
    pipelined_store = sched.store_stages > 1
    c_slots = 2 if pipelined_store else 1
    prog = g.make_program(g.std_buffers(c_slots=c_slots), name="summa")

    pending_stores: List[DMAOp] = []
    store_quota = max(1, (g.gm * g.gn + sched.store_stages - 1) // sched.store_stages)
    it = 0
    for om in range(g.iter_m):
        for on in range(g.iter_n):
            acc_slot = it % c_slots
            if db:
                prog.add(Superstep(comm=_fetch_and_multicast(g, om, on, 0, 0),
                                   label=f"i{om},{on} pro"))
                for t in range(g.n_ksteps):
                    step = Superstep(label=f"i{om},{on} k{t}")
                    for lm in range(g.gm):
                        for ln in range(g.gn):
                            step.compute.append(MMADOp(
                                g.coord(lm, ln), "A", t % 2, "B", t % 2, "C",
                                acc_slot, init=(t == 0), tm=g.tm, tn=g.tn, tk=g.tk))
                    if t + 1 < g.n_ksteps:
                        step.comm.extend(_fetch_and_multicast(g, om, on, t + 1, (t + 1) % 2))
                    # pipelined store of the previous iteration's C (fixed
                    # per-stage quota so the drain always completes)
                    if pending_stores:
                        step.comm.extend(pending_stores[:store_quota])
                        del pending_stores[:store_quota]
                    prog.add(step)
            else:
                for t in range(g.n_ksteps):
                    prog.add(Superstep(comm=_fetch_and_multicast(g, om, on, t, 0),
                                       label=f"i{om},{on} fetch k{t}"))
                    step = Superstep(label=f"i{om},{on} k{t}")
                    for lm in range(g.gm):
                        for ln in range(g.gn):
                            step.compute.append(MMADOp(
                                g.coord(lm, ln), "A", 0, "B", 0, "C", acc_slot,
                                init=(t == 0), tm=g.tm, tn=g.tn, tk=g.tk))
                    prog.add(step)

            if pending_stores:
                # iteration had fewer k-steps than store stages: flush the rest
                prog.add(Superstep(comm=list(pending_stores), label="store flush"))
                pending_stores.clear()
            stores = _stores(g, om, on, acc_slot)
            if pipelined_store and not (om == g.iter_m - 1 and on == g.iter_n - 1):
                pending_stores = stores      # drain into the next iteration
            else:
                stages = max(1, sched.store_stages)
                per = (len(stores) + stages - 1) // stages
                for s0 in range(0, len(stores), per):
                    prog.add(Superstep(comm=stores[s0:s0 + per],
                                       label=f"i{om},{on} store"))
            it += 1
    if pending_stores:
        prog.add(Superstep(comm=pending_stores, label="final store drain"))
    return prog
