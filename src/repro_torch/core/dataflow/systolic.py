"""Systolic dataflow (paper §3.3.2, Fig. 6b).

Output-stationary systolic GEMM: A tiles propagate rightward, B tiles
propagate downward, computation proceeds as a spatial wavefront driven
entirely by nearest-neighbour communication. Tile (i, j) consumes k-chunk t
at superstep t + i + j; west-edge tiles inject A from HBM, north-edge tiles
inject B. Loads are naturally staggered across supersteps (no HBM burst),
but the wavefront costs gm + gn - 2 fill supersteps — the pipelining
trade-off of Fig. 8.

Mesh-execution analogue: `dit_gemm` mode `cannon` (docs/dataflows.md).
"""
from __future__ import annotations

from repro_torch.core.dataflow.common import GridView
from repro_torch.core.ir import DMAOp, MMADOp, P2POp, Program, Superstep
from repro_torch.core.schedule import Schedule
from repro_torch.hw.config import AcceleratorConfig


def build(sched: Schedule, hw: AcceleratorConfig) -> Program:
    if sched.tiling.gk != 1:
        raise ValueError("systolic dataflow is 2-D (gk must be 1)")
    g = GridView(sched, hw)
    # systolic needs 2 slots even without the double_buffer flag: a tile
    # forwards chunk t while computing on it; flag only controls overlap of
    # injection DMA (modelled identically here).
    prog = g.make_program(g.std_buffers(), name="systolic")
    for b in prog.buffers.values():
        if b.name in ("A", "B"):
            b.slots = 2

    for om in range(g.iter_m):
        for on in range(g.iter_n):
            total = g.n_ksteps + g.gm + g.gn - 2
            # superstep s = -1 .. total-1; s covers injections for arrival at s+1
            for s in range(-1, total):
                step = Superstep(label=f"i{om},{on} s{s}")
                # compute: tile (lm, ln) works on chunk t = s - lm - ln
                for lm in range(g.gm):
                    for ln in range(g.gn):
                        t = s - lm - ln
                        if 0 <= t < g.n_ksteps:
                            step.compute.append(MMADOp(
                                g.coord(lm, ln), "A", t % 2, "B", t % 2, "C", 0,
                                init=(t == 0), tm=g.tm, tn=g.tn, tk=g.tk))
                # propagation: tile holding chunk t at step s forwards it for
                # arrival at s+1 (east for A, south for B).
                for lm in range(g.gm):
                    for ln in range(g.gn):
                        t = s - lm - ln
                        if 0 <= t < g.n_ksteps:
                            if ln + 1 < g.gn:
                                step.comm.append(P2POp(g.coord(lm, ln),
                                                       g.coord(lm, ln + 1), "A", t % 2))
                            if lm + 1 < g.gm:
                                step.comm.append(P2POp(g.coord(lm, ln),
                                                       g.coord(lm + 1, ln), "B", t % 2))
                # injection: west edge loads A(lm, t') arriving at s+1 = t' + lm
                for lm in range(g.gm):
                    t_in = s + 1 - lm
                    if 0 <= t_in < g.n_ksteps:
                        step.comm.append(DMAOp(g.coord(lm, 0), "load", "A",
                                               g.a_tile(om, lm, t_in), "A", t_in % 2))
                for ln in range(g.gn):
                    t_in = s + 1 - ln
                    if 0 <= t_in < g.n_ksteps:
                        step.comm.append(DMAOp(g.coord(0, ln), "load", "B",
                                               g.b_tile(on, ln, t_in), "B", t_in % 2))
                if step.compute or step.comm:
                    prog.add(step)
            # drain: store C
            stages = max(1, sched.store_stages)
            n_tiles = g.gm * g.gn
            stores = [DMAOp(g.coord(lm, ln), "store", "C",
                            g.c_tile(om, on, lm, ln), "C", 0)
                      for lm in range(g.gm) for ln in range(g.gn)]
            per = (n_tiles + stages - 1) // stages
            for s0 in range(0, n_tiles, per):
                prog.add(Superstep(comm=stores[s0:s0 + per], label=f"i{om},{on} store"))
    return prog
