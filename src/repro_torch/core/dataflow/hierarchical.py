"""Hierarchical dataflow schedules (paper §3.3.2, Fig. 6c/6d).

The logical grid is partitioned into an outer (Om x On) grid of inner
(ih x iw) tile groups (sched.inner; square groups required, as in the paper's
2x2-over-2x2 example). Two compositions:

- **systolic over SUMMA** (Fig. 6c): each inner group runs SUMMA on its
  reduced (M/Om x N/On x K) subproblem while A/B chunks propagate between
  groups as a global systolic wavefront (group (oi,oj) consumes outer k-chunk
  t at outer step t + oi + oj).
- **SUMMA over systolic** (Fig. 6d): each inner group runs a local systolic
  GEMM while the outer grid executes SUMMA propagation — owner groups
  multicast A strips along outer rows / B strips down outer columns (strided
  mask groups), and all groups start every chunk simultaneously.

All collectives here are single hardware mask collectives: inner rows/cols and
outer-strided rows/cols fix aligned power-of-2 bit-ranges of the flat index.

Mesh-execution analogue: each composition lowers (via
`repro_torch.core.lower.lower_schedule`) to its OWN `dit_gemm` mode on a 4-axis
mesh view — `summa_over_systolic` (Fig. 6d) to `hierarchical` (outer SUMMA
over inner Cannon groups) and `systolic_over_summa` (Fig. 6c) to
`outer_systolic` (an outer Cannon ring of inner SUMMA groups; the
group-to-group hold propagation below becomes `ppermute` ring steps over
the outer mesh axes). Fig. 6c needs a square outer grid of at least 2×2
for its ring and falls back to `hierarchical` otherwise, with the reason
recorded — see docs/dataflows.md ("Fig. 6c vs 6d") for the side-by-side
collective patterns and fallback chains.
"""
from __future__ import annotations

from repro_torch.core.dataflow.common import GridView
from repro_torch.core.ir import BufferDecl, DMAOp, MMADOp, MulticastOp, P2POp, Program, Superstep
from repro_torch.core.masks import TileGroup
from repro_torch.core.remap import flat_mask_group
from repro_torch.core.schedule import Schedule
from repro_torch.hw.config import AcceleratorConfig


class _HierView(GridView):
    """GridView + inner/outer group index algebra (gk must be 1)."""

    def setup(self, inner):
        self.ih, self.iw = inner
        if self.ih != self.iw:
            raise ValueError(f"hierarchical schedules need square inner groups, got {inner}")
        if self.gm % self.ih or self.gn % self.iw:
            raise ValueError(f"inner {inner} must divide logical grid ({self.gm}x{self.gn})")
        self.Om, self.On = self.gm // self.ih, self.gn // self.iw
        self._full2 = self.gm * self.gn - 1
        self._gnb = (self.gn - 1).bit_length()

    def lcoord(self, oi, oj, li, lj):
        return self.coord(oi * self.ih + li, oj * self.iw + lj)

    def inner_row_group(self, oi, oj, li) -> TileGroup:
        """{(oi*ih+li, oj*iw + *)} — lj free."""
        sel = (oi * self.ih + li) * self.gn + oj * self.iw
        return flat_mask_group(sel, self._full2 & ~(self.iw - 1), self.phys)

    def inner_col_group(self, oi, oj, lj) -> TileGroup:
        """{(oi*ih + *, oj*iw+lj)} — li free."""
        sel = (oi * self.ih) * self.gn + oj * self.iw + lj
        free = (self.ih - 1) << self._gnb
        return flat_mask_group(sel, self._full2 & ~free, self.phys)

    def outer_row_group(self, oi, li, lj) -> TileGroup:
        """Counterpart tiles (li, lj) of every group in outer row oi — oj free."""
        sel = (oi * self.ih + li) * self.gn + lj
        free = (self.On - 1) * self.iw
        return flat_mask_group(sel, self._full2 & ~free, self.phys)

    def outer_col_group(self, oj, li, lj) -> TileGroup:
        """Counterpart tiles (li, lj) of every group in outer col oj — oi free."""
        sel = li * self.gn + oj * self.iw + lj
        free = ((self.Om - 1) * self.ih) << self._gnb
        return flat_mask_group(sel, self._full2 & ~free, self.phys)

    def final_stores(self, prog, sched, om, on):
        stores = [DMAOp(self.coord(lm, ln), "store", "C",
                        self.c_tile(om, on, lm, ln), "C", 0)
                  for lm in range(self.gm) for ln in range(self.gn)]
        stages = max(1, sched.store_stages)
        per = (len(stores) + stages - 1) // stages
        for s0 in range(0, len(stores), per):
            prog.add(Superstep(comm=stores[s0:s0 + per], label="store"))


# ---------------------------------------------------------------------------
# Fig. 6c — systolic over SUMMA
# ---------------------------------------------------------------------------
#
# Hold distribution: tile (li, lj) of a group holds A(row li, inner chunk lj)
# in Ahold and B(inner chunk li, col lj) in Bhold (square groups: both chunk
# indices range over ih == iw). Outer chunk t moves group-to-group by P2P of
# the holds; the inner SUMMA multicasts hold slices with tau-parity working
# slots.

def build_systolic_over_summa(sched: Schedule, hw: AcceleratorConfig) -> Program:
    if sched.tiling.gk != 1:
        raise ValueError("hierarchical dataflows are 2-D (gk must be 1)")
    g = _HierView(sched, hw)
    g.setup(sched.inner)
    if g.n_ksteps % g.iw:
        raise ValueError(f"n_ksteps={g.n_ksteps} must divide by inner width {g.iw}")
    n_outer = g.n_ksteps // g.iw   # outer chunks; each holds iw inner tk-chunks
    n_inner = g.iw
    dt = g.dtype()
    bufs = g.std_buffers()
    # the wavefront always needs 2 working slots (compute t, receive t+1)
    bufs["A"].slots = bufs["B"].slots = 2
    bufs["Ahold"] = BufferDecl("Ahold", (g.tm, g.tk), slots=2, dtype=dt)
    bufs["Bhold"] = BufferDecl("Bhold", (g.tk, g.tn), slots=2, dtype=dt)
    prog = g.make_program(bufs, name="systolic_over_summa")

    def active(s):
        for oi in range(g.Om):
            for oj in range(g.On):
                t = s - oi - oj
                if 0 <= t < n_outer:
                    yield oi, oj, t

    for om in range(g.iter_m):
        for on in range(g.iter_n):
            total = n_outer + g.Om + g.On - 2
            for s in range(-1, total):
                # pre-superstep: systolic hop of holds, HBM injection for s+1,
                # and the inner multicast of chunk tau=0 for this outer step.
                pre = Superstep(label=f"s{s} pre")
                for oi, oj, t in active(s):
                    for li in range(g.ih):
                        for lj in range(g.iw):
                            src = g.lcoord(oi, oj, li, lj)
                            if oj + 1 < g.On:
                                pre.comm.append(P2POp(src, g.lcoord(oi, oj + 1, li, lj),
                                                      "Ahold", t % 2))
                            if oi + 1 < g.Om:
                                pre.comm.append(P2POp(src, g.lcoord(oi + 1, oj, li, lj),
                                                      "Bhold", t % 2))
                for oi in range(g.Om):           # west-edge A injection
                    t_in = s + 1 - oi
                    if 0 <= t_in < n_outer:
                        for li in range(g.ih):
                            for lj in range(g.iw):
                                pre.comm.append(DMAOp(
                                    g.lcoord(oi, 0, li, lj), "load", "A",
                                    g.a_tile(om, oi * g.ih + li, t_in * n_inner + lj),
                                    "Ahold", t_in % 2))
                for oj in range(g.On):           # north-edge B injection
                    t_in = s + 1 - oj
                    if 0 <= t_in < n_outer:
                        for li in range(g.ih):
                            for lj in range(g.iw):
                                pre.comm.append(DMAOp(
                                    g.lcoord(0, oj, li, lj), "load", "B",
                                    g.b_tile(on, oj * g.iw + lj, t_in * n_inner + li),
                                    "Bhold", t_in % 2))
                for oi, oj, t in active(s):      # inner SUMMA multicast tau=0
                    for li in range(g.ih):
                        pre.comm.append(MulticastOp(
                            g.lcoord(oi, oj, li, 0), g.inner_row_group(oi, oj, li),
                            "Ahold", t % 2, dst_buf="A", dst_slot=0))
                    for lj in range(g.iw):
                        pre.comm.append(MulticastOp(
                            g.lcoord(oi, oj, 0, lj), g.inner_col_group(oi, oj, lj),
                            "Bhold", t % 2, dst_buf="B", dst_slot=0))
                if pre.comm:
                    prog.add(pre)
                # inner SUMMA steps tau = 0..n_inner-1 with tau-parity slots.
                for tau in range(n_inner):
                    step = Superstep(label=f"s{s} tau{tau}")
                    for oi, oj, t in active(s):
                        for li in range(g.ih):
                            for lj in range(g.iw):
                                step.compute.append(MMADOp(
                                    g.lcoord(oi, oj, li, lj), "A", tau % 2,
                                    "B", tau % 2, "C", 0,
                                    init=(t == 0 and tau == 0),
                                    tm=g.tm, tn=g.tn, tk=g.tk))
                        if tau + 1 < n_inner:
                            for li in range(g.ih):
                                step.comm.append(MulticastOp(
                                    g.lcoord(oi, oj, li, tau + 1),
                                    g.inner_row_group(oi, oj, li),
                                    "Ahold", t % 2, dst_buf="A", dst_slot=(tau + 1) % 2))
                            for lj in range(g.iw):
                                step.comm.append(MulticastOp(
                                    g.lcoord(oi, oj, tau + 1, lj),
                                    g.inner_col_group(oi, oj, lj),
                                    "Bhold", t % 2, dst_buf="B", dst_slot=(tau + 1) % 2))
                    if step.compute or step.comm:
                        prog.add(step)
            g.final_stores(prog, sched, om, on)
    return prog


# ---------------------------------------------------------------------------
# Fig. 6d — SUMMA over systolic
# ---------------------------------------------------------------------------

def build_summa_over_systolic(sched: Schedule, hw: AcceleratorConfig) -> Program:
    if sched.tiling.gk != 1:
        raise ValueError("hierarchical dataflows are 2-D (gk must be 1)")
    g = _HierView(sched, hw)
    g.setup(sched.inner)
    n_inner = g.iw                     # inner tk-chunks per outer SUMMA step
    if g.n_ksteps % n_inner:
        raise ValueError(f"n_ksteps={g.n_ksteps} must divide by inner width {g.iw}")
    n_outer = g.n_ksteps // n_inner
    dt = g.dtype()
    bufs = g.std_buffers()
    # the wavefront always needs 2 working slots (compute t, receive t+1)
    bufs["A"].slots = bufs["B"].slots = 2
    # full strip of the outer chunk on west/north counterpart tiles; one slot
    # per inner chunk so the systolic feed can index chunk tau directly.
    bufs["Afeed"] = BufferDecl("Afeed", (g.tm, g.tk), slots=n_inner, dtype=dt)
    bufs["Bfeed"] = BufferDecl("Bfeed", (g.tk, g.tn), slots=n_inner, dtype=dt)
    prog = g.make_program(bufs, name="summa_over_systolic")

    for om in range(g.iter_m):
        for on in range(g.iter_n):
            for T in range(n_outer):
                # owner groups DMA strips (one DMA per inner chunk slot).
                load = Superstep(label=f"T{T} load")
                for oi in range(g.Om):
                    for li in range(g.ih):
                        for tau in range(n_inner):
                            load.comm.append(DMAOp(
                                g.lcoord(oi, T % g.On, li, 0), "load", "A",
                                g.a_tile(om, oi * g.ih + li, T * n_inner + tau),
                                "Afeed", tau))
                for oj in range(g.On):
                    for lj in range(g.iw):
                        for tau in range(n_inner):
                            load.comm.append(DMAOp(
                                g.lcoord(T % g.Om, oj, 0, lj), "load", "B",
                                g.b_tile(on, oj * g.iw + lj, T * n_inner + tau),
                                "Bfeed", tau))
                prog.add(load)
                # outer SUMMA multicast to west/north counterparts of every group.
                mc = Superstep(label=f"T{T} outer-mcast")
                for oi in range(g.Om):
                    for li in range(g.ih):
                        for tau in range(n_inner):
                            mc.comm.append(MulticastOp(
                                g.lcoord(oi, T % g.On, li, 0),
                                g.outer_row_group(oi, li, 0), "Afeed", tau))
                for oj in range(g.On):
                    for lj in range(g.iw):
                        for tau in range(n_inner):
                            mc.comm.append(MulticastOp(
                                g.lcoord(T % g.Om, oj, 0, lj),
                                g.outer_col_group(oj, 0, lj), "Bfeed", tau))
                prog.add(mc)
                # inner systolic wavefront over the strip (all groups at once).
                total = n_inner + g.ih + g.iw - 2
                for sg in range(-1, total):
                    step = Superstep(label=f"T{T} sg{sg}")
                    for oi in range(g.Om):
                        for oj in range(g.On):
                            for li in range(g.ih):
                                for lj in range(g.iw):
                                    tile = g.lcoord(oi, oj, li, lj)
                                    tau = sg - li - lj
                                    if 0 <= tau < n_inner:
                                        step.compute.append(MMADOp(
                                            tile, "A", tau % 2, "B", tau % 2, "C", 0,
                                            init=(T == 0 and tau == 0),
                                            tm=g.tm, tn=g.tn, tk=g.tk))
                                        if lj + 1 < g.iw:
                                            step.comm.append(P2POp(
                                                tile, g.lcoord(oi, oj, li, lj + 1),
                                                "A", tau % 2))
                                        if li + 1 < g.ih:
                                            step.comm.append(P2POp(
                                                tile, g.lcoord(oi, oj, li + 1, lj),
                                                "B", tau % 2))
                                    # west/north edge feeds for arrival at sg+1
                                    if lj == 0:
                                        ti = sg + 1 - li
                                        if 0 <= ti < n_inner:
                                            step.comm.append(P2POp(
                                                tile, tile, "Afeed", ti,
                                                dst_buf="A", dst_slot=ti % 2))
                                    if li == 0:
                                        tj = sg + 1 - lj
                                        if 0 <= tj < n_inner:
                                            step.comm.append(P2POp(
                                                tile, tile, "Bfeed", tj,
                                                dst_buf="B", dst_slot=tj % 2))
                    if step.compute or step.comm:
                        prog.add(step)
            g.final_stores(prog, sched, om, on)
    return prog
