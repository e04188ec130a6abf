"""Cluster index remap (paper §3.1.2).

The physical compute-tile grid is fixed (e.g. 32x32) but the optimal mapping
depends on the GEMM dimensions, so DiT reinterprets the physical grid as a
*logical* grid (1x1024, 2x512, 64x16, ...). Collectives specified on the
logical topology are automatically lowered to mask groups on the physical
grid — this module implements that lowering.

Layout convention: logical index L = lr * logical_cols + lc enumerates tiles
in *physical row-major order* (L = pi * phys_cols + pj). With power-of-2
dimensions everywhere, the bits of L split as [lr bits | lc bits] and also as
[pi bits | pj bits], so any logical row/column/rect group fixes a subset of
L's bits — which is exactly a (selector, mask) pair on (pi, pj). Hence every
logical-topology collective is ONE hardware mask collective: remap is free.
"""
from __future__ import annotations

import dataclasses
from typing import List, Tuple

from repro_torch.core.masks import MaskSpec, TileGroup, axis_bits


@dataclasses.dataclass(frozen=True)
class ClusterRemap:
    """Reinterpret `physical` (rows, cols) as `logical` (rows, cols)."""
    physical: Tuple[int, int]
    logical: Tuple[int, int]

    def __post_init__(self):
        pn = self.physical[0] * self.physical[1]
        ln = self.logical[0] * self.logical[1]
        if pn != ln:
            raise ValueError(f"logical grid {self.logical} must cover the "
                             f"physical grid {self.physical} exactly ({ln} != {pn})")
        for extent in (*self.physical, *self.logical):
            if extent & (extent - 1):
                raise ValueError(f"extent {extent} must be a power of two")

    # -- index mapping ------------------------------------------------------

    def to_physical(self, lr: int, lc: int) -> Tuple[int, int]:
        flat = lr * self.logical[1] + lc
        return divmod(flat, self.physical[1])

    def to_logical(self, pi: int, pj: int) -> Tuple[int, int]:
        flat = pi * self.physical[1] + pj
        return divmod(flat, self.logical[1])

    # -- collective lowering --------------------------------------------------

    def _flat_group_to_physical(self, sel: int, mask: int) -> TileGroup:
        """A group over the flat index {L : (L & mask) == sel} as a physical
        (row, col) mask group. Bits [pj_bits) of L are pj; the rest are pi."""
        pj_bits = axis_bits(self.physical[1])
        pj_mask = (1 << pj_bits) - 1
        return TileGroup(
            row=MaskSpec(sel >> pj_bits, mask >> pj_bits),
            col=MaskSpec(sel & pj_mask, mask & pj_mask),
        )

    def logical_row_group(self, lr: int) -> TileGroup:
        """All tiles with logical row == lr, as ONE physical mask group."""
        lc_bits = axis_bits(self.logical[1])
        lr_mask = ((self.logical[0] - 1)) << lc_bits
        return self._flat_group_to_physical(lr << lc_bits, lr_mask)

    def logical_col_group(self, lc: int) -> TileGroup:
        """All tiles with logical col == lc, as ONE physical mask group."""
        lc_bits = axis_bits(self.logical[1])
        return self._flat_group_to_physical(lc, (1 << lc_bits) - 1)

    def logical_rect_group(self, lr0: int, lc0: int, h: int, w: int) -> TileGroup:
        """Aligned power-of-2 logical rectangle as ONE physical mask group."""
        if h & (h - 1) or w & (w - 1):
            raise ValueError("rect dims must be powers of two")
        if lr0 % h or lc0 % w:
            raise ValueError("rect origin must be aligned to its size")
        lc_bits = axis_bits(self.logical[1])
        sel = (lr0 << lc_bits) | lc0
        mask = (((self.logical[0] - 1) & ~(h - 1)) << lc_bits) | ((self.logical[1] - 1) & ~(w - 1))
        return self._flat_group_to_physical(sel, mask)

    def logical_members(self, group: TileGroup) -> List[Tuple[int, int]]:
        """Logical coordinates of a physical mask group's members."""
        return sorted(self.to_logical(i, j) for i, j in group.members(self.physical))


def flat_mask_group(selector: int, mask: int, physical: Tuple[int, int]) -> TileGroup:
    """A group over the row-major flat tile index, {L : (L & mask) == selector},
    expressed as a physical (row, col) mask group. Used by 3-D split-K: with
    flat = ((lm * gn) + ln) * gk + lk, every k-group / strided-broadcast group
    fixes a bit range of L, hence is ONE hardware mask collective."""
    pj_bits = axis_bits(physical[1])
    pj_mask = (1 << pj_bits) - 1
    return TileGroup(
        row=MaskSpec(selector >> pj_bits, mask >> pj_bits),
        col=MaskSpec(selector & pj_mask, mask & pj_mask),
    )


def candidate_remaps(physical: Tuple[int, int]) -> List[ClusterRemap]:
    """All power-of-2 logical reinterpretations of a physical grid — the remap
    search space the autotuner enumerates (paper Insight 4 picks 1x1024 for
    flat GEMM on a 32x32 grid)."""
    n = physical[0] * physical[1]
    remaps = []
    rows = 1
    while rows <= n:
        remaps.append(ClusterRemap(physical, (rows, n // rows)))
        rows *= 2
    return remaps
