"""Mask-based collective addressing (paper §2.1).

SoftHier's NoC collectives address a *group* of tiles with a selector/mask pair
per grid dimension:

    Tile_group = { Tile_{i,j} in P | (i & M_row) == S_row  and  (j & M_col) == S_col }

A packet header carries (S_row, S_col) and (M_row, M_col); every tile whose
coordinates match joins the multicast (or contributes to the reduction).
Rows (M_row = full, M_col = 0), columns, rectangles, and power-of-2-strided
subsets are all expressible.

This module implements that calculus exactly, plus the bridge the TPU backend
needs: a power-of-2 mask over an axis of size 2^k is equivalent to *splitting*
that axis into binary sub-axes and grouping over the sub-axes whose mask bit is
0. That equivalence (proved by `tests/test_masks.py` with hypothesis) is what
lets the paper's mask groups lower onto named-mesh-axis collectives in JAX.
"""
from __future__ import annotations

import dataclasses
from typing import List, Sequence, Tuple


@dataclasses.dataclass(frozen=True)
class MaskSpec:
    """Selector/mask pair for one grid dimension."""
    selector: int
    mask: int

    def matches(self, coord: int) -> bool:
        return (coord & self.mask) == self.selector

    def validate(self) -> None:
        if self.selector & ~self.mask:
            raise ValueError(
                f"selector {self.selector:#x} has bits outside mask {self.mask:#x}; "
                "the group would be empty")


@dataclasses.dataclass(frozen=True)
class TileGroup:
    """A 2-D collective group = row spec x col spec (paper eq. in §2.1)."""
    row: MaskSpec
    col: MaskSpec

    def members(self, grid: Tuple[int, int]) -> List[Tuple[int, int]]:
        rows, cols = grid
        return [(i, j) for i in range(rows) for j in range(cols)
                if self.row.matches(i) and self.col.matches(j)]

    def contains(self, i: int, j: int) -> bool:
        return self.row.matches(i) and self.col.matches(j)

    def size(self, grid: Tuple[int, int]) -> int:
        return len(self.members(grid))


# -- constructors for the common patterns the paper uses --------------------

def _full_mask(extent: int) -> int:
    if extent & (extent - 1):
        raise ValueError(f"grid extent {extent} must be a power of two for mask addressing")
    return extent - 1


def row_group(i: int, grid: Tuple[int, int]) -> TileGroup:
    """All tiles in row i — the SUMMA horizontal-broadcast group."""
    return TileGroup(MaskSpec(i, _full_mask(grid[0])), MaskSpec(0, 0))


def col_group(j: int, grid: Tuple[int, int]) -> TileGroup:
    """All tiles in column j — the SUMMA vertical-broadcast group."""
    return TileGroup(MaskSpec(0, 0), MaskSpec(j, _full_mask(grid[1])))


def rect_group(i0: int, j0: int, h: int, w: int, grid: Tuple[int, int]) -> TileGroup:
    """An aligned power-of-2 rectangle with top-left corner (i0, j0).

    Used by hierarchical schedules: an inner (h x w) tile group at an aligned
    position is one mask group.
    """
    for extent, size, origin in ((grid[0], h, i0), (grid[1], w, j0)):
        if size & (size - 1):
            raise ValueError(f"rect size {size} must be a power of two")
        if origin % size:
            raise ValueError(f"rect origin {origin} must be aligned to size {size}")
    row = MaskSpec(i0, _full_mask(grid[0]) & ~(h - 1))
    col = MaskSpec(j0, _full_mask(grid[1]) & ~(w - 1))
    return TileGroup(row, col)


def strided_group(phase_i: int, stride_i: int, phase_j: int, stride_j: int,
                  grid: Tuple[int, int]) -> TileGroup:
    """Tiles {(i, j) : i % stride_i == phase_i, j % stride_j == phase_j} for
    power-of-2 strides — the 'strided broadcast' used by split-K (§3.3.2).

    i % 2^k == phase  <=>  (i & (2^k - 1)) == phase, i.e. mask = stride-1.
    """
    for stride in (stride_i, stride_j):
        if stride & (stride - 1):
            raise ValueError(f"stride {stride} must be a power of two")
    return TileGroup(MaskSpec(phase_i, stride_i - 1), MaskSpec(phase_j, stride_j - 1))


def all_group() -> TileGroup:
    """Every tile — full-grid broadcast."""
    return TileGroup(MaskSpec(0, 0), MaskSpec(0, 0))


def single(i: int, j: int, grid: Tuple[int, int]) -> TileGroup:
    return TileGroup(MaskSpec(i, _full_mask(grid[0])), MaskSpec(j, _full_mask(grid[1])))


# ---------------------------------------------------------------------------
# Mask <-> binary sub-axis equivalence (the TPU lowering bridge).
# ---------------------------------------------------------------------------

def axis_bits(extent: int) -> int:
    m = _full_mask(extent)
    return m.bit_length()


def mask_to_subaxes(spec: MaskSpec, extent: int) -> Tuple[Tuple[int, ...], int]:
    """Decompose a mask group over an axis of size 2^k into binary sub-axes.

    Viewing coordinate i as bits (b_{k-1} ... b_0), the group
    {i : (i & M) == S} fixes the bits where M is 1 (to S's bits) and leaves the
    bits where M is 0 free. Returns (free_bit_positions, fixed_value):
    the group is exactly the set of coordinates obtained by enumerating the
    free bits with the fixed bits set to `fixed_value`.

    On a named JAX mesh this means: reshape the axis into k binary sub-axes;
    the collective runs over the sub-axes at `free_bit_positions`.
    """
    spec.validate()
    k = axis_bits(extent)
    free = tuple(b for b in range(k) if not (spec.mask >> b) & 1)
    return free, spec.selector


def subaxes_to_members(free_bits: Sequence[int], fixed_value: int, extent: int) -> List[int]:
    """Enumerate the axis coordinates of a (free_bits, fixed_value) group."""
    members = []
    for n in range(1 << len(free_bits)):
        coord = fixed_value
        for idx, bit in enumerate(free_bits):
            if (n >> idx) & 1:
                coord |= 1 << bit
        if coord < extent:
            members.append(coord)
    return sorted(members)


def group_to_device_ids(group: TileGroup, grid: Tuple[int, int]) -> List[int]:
    """Flattened (row-major) device ids of a group — the form collective
    `device_groups` take in XLA."""
    return [i * grid[1] + j for (i, j) in group.members(grid)]


def partition_grid(grid: Tuple[int, int], inner: Tuple[int, int]) -> List[TileGroup]:
    """Partition the grid into aligned inner rectangles (hierarchical schedules).

    Returns the list of disjoint rect groups covering the grid; used by
    systolic-over-SUMMA / SUMMA-over-systolic to address each inner group with
    a single hardware collective.
    """
    gh, gw = grid
    ih, iw = inner
    if gh % ih or gw % iw:
        raise ValueError(f"inner {inner} must divide grid {grid}")
    groups = []
    for i0 in range(0, gh, ih):
        for j0 in range(0, gw, iw):
            groups.append(rect_group(i0, j0, ih, iw, grid))
    return groups
