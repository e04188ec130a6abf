"""Shared machinery for the dataflow pattern builders (paper §3.3.2).

`GridView` resolves a Schedule's logical (gm x gn x gk) grid onto the physical
tile grid through the flat row-major index (the cluster-index-remap mechanism,
§3.1.2): flat = ((lm * gn) + ln) * gk + lk. Because every extent is a power of
two, each logical row / column / k-group fixes a bit-range of the flat index
and therefore lowers to ONE hardware mask collective (`flat_mask_group`).
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Tuple

from repro_torch.core.ir import BufferDecl, Program
from repro_torch.core.masks import TileGroup, axis_bits
from repro_torch.core.remap import flat_mask_group
from repro_torch.core.schedule import (DTYPE_OF_BYTES, GEMMShape, Schedule,
                                 elem_dtype_name, resolve_layouts)
from repro_torch.hw.config import AcceleratorConfig

__all__ = ["DTYPE_OF_BYTES", "GridView"]  # DTYPE_OF_BYTES re-exported for importers


@dataclasses.dataclass
class GridView:
    sched: Schedule
    hw: AcceleratorConfig

    def __post_init__(self):
        t = self.sched.tiling
        self.phys: Tuple[int, int] = self.hw.grid
        self.gm, self.gn, self.gk = t.gm, t.gn, t.gk
        self.tm, self.tn, self.k_local = t.tile_dims(self.sched.shape)
        self.tk = min(t.tk, self.k_local)
        self.n_ksteps = self.k_local // self.tk
        self.iter_m, self.iter_n = t.iter_m, t.iter_n
        self._gk_bits = axis_bits(self.gk) if self.gk > 1 else 0
        self._gn_bits = axis_bits(self.gn) if self.gn > 1 else 0
        self._full = self.gm * self.gn * self.gk - 1

    # -- logical <-> physical ------------------------------------------------

    def flat(self, lm: int, ln: int, lk: int = 0) -> int:
        return ((lm * self.gn) + ln) * self.gk + lk

    def coord(self, lm: int, ln: int, lk: int = 0) -> Tuple[int, int]:
        return divmod(self.flat(lm, ln, lk), self.phys[1])

    # -- collective groups (each is ONE mask collective) ----------------------

    def row_group(self, lm: int, lk: int = 0) -> TileGroup:
        """All tiles in logical row lm of k-slice lk ({ln} free)."""
        sel = self.flat(lm, 0, lk)
        free = ((self.gn - 1) << self._gk_bits)
        return flat_mask_group(sel, self._full & ~free, self.phys)

    def col_group(self, ln: int, lk: int = 0) -> TileGroup:
        """All tiles in logical column ln of k-slice lk ({lm} free)."""
        sel = self.flat(0, ln, lk)
        free = ((self.gm - 1) << (self._gk_bits + self._gn_bits))
        return flat_mask_group(sel, self._full & ~free, self.phys)

    def k_group(self, lm: int, ln: int) -> TileGroup:
        """All k-slice peers of output tile (lm, ln) ({lk} free) — the
        split-K reduction group."""
        sel = self.flat(lm, ln, 0)
        free = self.gk - 1
        return flat_mask_group(sel, self._full & ~free, self.phys)

    # -- buffer plan -----------------------------------------------------------

    def dtype(self) -> str:
        # schedule's explicit dtype > hardware's native engine dtype (when the
        # byte widths agree — the gh200 preset's fp8) > legacy byte default.
        return elem_dtype_name(self.sched, self.hw)

    def make_program(self, buffers: Dict[str, BufferDecl], name: str) -> Program:
        return Program(
            grid=self.phys,
            shape=(self.sched.shape.m, self.sched.shape.n, self.sched.shape.k),
            tile_shape=(self.tm, self.tn, self.tk),
            buffers=buffers,
            layouts=resolve_layouts(self.sched, self.hw),
            double_buffer=self.sched.double_buffer,
            name=name,
            elem_bytes=self.sched.elem_bytes,
        )

    def std_buffers(self, *, c_slots: int = 1) -> Dict[str, BufferDecl]:
        """A/B working buffers + C accumulator. Owners DMA straight into the
        working buffer and the fabric multicast chains off the DMA in the same
        superstep (after_dma), so no separate staging buffers are needed."""
        db = 2 if self.sched.double_buffer else 1
        dt = self.dtype()
        acc_dt = "float16" if self.sched.acc_bytes == 2 else "float32"
        return {
            "A": BufferDecl("A", (self.tm, self.tk), slots=db, dtype=dt),
            "B": BufferDecl("B", (self.tk, self.tn), slots=db, dtype=dt),
            "C": BufferDecl("C", (self.tm, self.tn), slots=c_slots, dtype=acc_dt),
        }

    # -- global tile coordinates ----------------------------------------------

    def a_tile(self, om: int, lm: int, kchunk: int, lk: int = 0) -> Tuple[int, int]:
        """(ti, tj) index of the A tile (TM x TK) for iteration om, logical row
        lm, k-chunk index kchunk within k-slice lk."""
        ti = om * self.gm + lm
        tj = lk * self.n_ksteps + kchunk
        return ti, tj

    def b_tile(self, on: int, ln: int, kchunk: int, lk: int = 0) -> Tuple[int, int]:
        ti = lk * self.n_ksteps + kchunk
        tj = on * self.gn + ln
        return ti, tj

    def c_tile(self, om: int, on: int, lm: int, ln: int) -> Tuple[int, int]:
        return om * self.gm + lm, on * self.gn + ln
