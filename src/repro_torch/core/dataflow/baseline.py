"""Baseline dataflow (paper §4.1.1): no NoC collectives, no data sharing.

Every tile independently DMAs its own A and B tiles from HBM each k-step —
the reference point without specialized placement or on-chip communication.
A's k-column is fetched by all gn tiles of a logical row (gn-fold HBM read
amplification; gm-fold for B), which is exactly why its operational intensity
is low in Fig. 7a.

Mesh-execution analogue: `dit_gemm` mode `allgather` (docs/dataflows.md).
"""
from __future__ import annotations

from repro_torch.core.dataflow.common import GridView
from repro_torch.core.ir import DMAOp, MMADOp, Program, Superstep
from repro_torch.core.schedule import Schedule
from repro_torch.hw.config import AcceleratorConfig


def build(sched: Schedule, hw: AcceleratorConfig) -> Program:
    if sched.tiling.gk != 1:
        raise ValueError("baseline dataflow is 2-D (gk must be 1)")
    g = GridView(sched, hw)
    prog = g.make_program(g.std_buffers(), name="baseline")
    db = sched.double_buffer

    def loads(om: int, on: int, t: int) -> list:
        slot = t % 2 if db else 0
        ops = []
        for lm in range(g.gm):
            for ln in range(g.gn):
                tile = g.coord(lm, ln)
                ops.append(DMAOp(tile, "load", "A", g.a_tile(om, lm, t), "A", slot))
                ops.append(DMAOp(tile, "load", "B", g.b_tile(on, ln, t), "B", slot))
        return ops

    for om in range(g.iter_m):
        for on in range(g.iter_n):
            # prologue: fetch chunk 0
            prog.add(Superstep(comm=loads(om, on, 0), label=f"i{om},{on} prologue"))
            for t in range(g.n_ksteps):
                step = Superstep(label=f"i{om},{on} k{t}")
                slot = t % 2 if db else 0
                for lm in range(g.gm):
                    for ln in range(g.gn):
                        step.compute.append(MMADOp(
                            g.coord(lm, ln), "A", slot, "B", slot, "C", 0,
                            init=(t == 0), tm=g.tm, tn=g.tn, tk=g.tk))
                if db and t + 1 < g.n_ksteps:
                    step.comm.extend(loads(om, on, t + 1))
                prog.add(step)
                if not db and t + 1 < g.n_ksteps:
                    prog.add(Superstep(comm=loads(om, on, t + 1),
                                       label=f"i{om},{on} load k{t+1}"))
            # store C (optionally split over stages)
            stages = max(1, sched.store_stages)
            rows_per_stage = max(1, g.gm // stages)
            for s0 in range(0, g.gm, rows_per_stage):
                step = Superstep(label=f"i{om},{on} store")
                for lm in range(s0, min(s0 + rows_per_stage, g.gm)):
                    for ln in range(g.gn):
                        step.comm.append(DMAOp(g.coord(lm, ln), "store", "C",
                                               g.c_tile(om, on, lm, ln), "C", 0))
                prog.add(step)
    return prog
