"""HBM data layout (paper §3.2).

SoftHier's HBM is a set of distinct per-channel address spaces, so DiT controls
the physical distribution of each matrix explicitly with two parameters:

- **Split scheme** (§3.2.1): partition the M x N matrix into a grid of blocks;
  blocks are the coarsest distribution unit, assigned to channels round-robin.
- **Placement scheme** (§3.2.2): inside one channel, a block is decomposed into
  TM x TN tiles stored contiguously in row-major order (tile sizes come from
  the workload tiling, §3.1).

The functional simulator uses `channel_of_block` / `tile_address` to place and
fetch real data; the cost model uses `channel_traffic` to detect channel
contention (the paper's Insight 1 — a bad layout leaves channels idle while
others are thrashed).

On the TPU target the analogous decisions are (a) the PartitionSpec that
shards an operand over chips (split scheme == which chip's HBM owns a block)
and (b) the BlockSpec tile shape inside a chip (placement scheme == the order
VMEM tiles stream from HBM).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, List, Tuple

import numpy as np


@dataclasses.dataclass(frozen=True)
class SplitScheme:
    """Partition an (M, N) matrix into a (grid_m x grid_n) grid of blocks."""
    grid_m: int
    grid_n: int

    def block_shape(self, shape: Tuple[int, int]) -> Tuple[int, int]:
        m, n = shape
        if m % self.grid_m or n % self.grid_n:
            raise ValueError(f"matrix {shape} not divisible by split {self}")
        return m // self.grid_m, n // self.grid_n

    def n_blocks(self) -> int:
        return self.grid_m * self.grid_n

    def block_index(self, bi: int, bj: int) -> int:
        return bi * self.grid_n + bj


@dataclasses.dataclass(frozen=True)
class PlacementScheme:
    """Arrange TM x TN tiles of one block contiguously (row-major) in the
    1-D address space of its channel."""
    tm: int
    tn: int

    def tiles_per_block(self, block_shape: Tuple[int, int]) -> Tuple[int, int]:
        bm, bn = block_shape
        if bm % self.tm or bn % self.tn:
            raise ValueError(f"block {block_shape} not divisible by tile ({self.tm},{self.tn})")
        return bm // self.tm, bn // self.tn


@dataclasses.dataclass(frozen=True)
class DataLayout:
    """Complete layout of one matrix across the distributed HBM channels."""
    split: SplitScheme
    placement: PlacementScheme
    n_channels: int
    # round-robin phase: block k lives on channel (k + phase) % n_channels.
    phase: int = 0

    def channel_of_block(self, bi: int, bj: int) -> int:
        return (self.split.block_index(bi, bj) + self.phase) % self.n_channels

    def block_of_tile(self, ti: int, tj: int, shape: Tuple[int, int]) -> Tuple[int, int]:
        """Which block the (ti, tj)-th TM x TN tile falls in."""
        bm, bn = self.split.block_shape(shape)
        return (ti * self.placement.tm) // bm, (tj * self.placement.tn) // bn

    def channel_of_tile(self, ti: int, tj: int, shape: Tuple[int, int]) -> int:
        bi, bj = self.block_of_tile(ti, tj, shape)
        return self.channel_of_block(bi, bj)

    def tile_address(self, ti: int, tj: int, shape: Tuple[int, int],
                     elem_bytes: int) -> Tuple[int, int]:
        """(channel, byte offset) of a tile — the preload-file address map."""
        bm, bn = self.split.block_shape(shape)
        tpb_m, tpb_n = self.placement.tiles_per_block((bm, bn))
        bi, bj = self.block_of_tile(ti, tj, shape)
        li, lj = ti - bi * tpb_m, tj - bj * tpb_n
        tile_bytes = self.placement.tm * self.placement.tn * elem_bytes
        # blocks mapped to the same channel stack up in channel address space.
        blocks_before = self.split.block_index(bi, bj) // self.n_channels
        block_bytes = tpb_m * tpb_n * tile_bytes
        offset = blocks_before * block_bytes + (li * tpb_n + lj) * tile_bytes
        return self.channel_of_block(bi, bj), offset

    # -- contention analysis -------------------------------------------------

    def channel_traffic(self, tile_reads: List[Tuple[int, int]],
                        shape: Tuple[int, int], elem_bytes: int) -> Dict[int, int]:
        """Bytes requested from each channel by a list of tile reads. The cost
        model turns the max/mean imbalance of this histogram into effective-
        bandwidth derating (contended channels serialize)."""
        traffic: Dict[int, int] = {}
        tile_bytes = self.placement.tm * self.placement.tn * elem_bytes
        for (ti, tj) in tile_reads:
            ch = self.channel_of_tile(ti, tj, shape)
            traffic[ch] = traffic.get(ch, 0) + tile_bytes
        return traffic


def base_layout(shape: Tuple[int, int], tm: int, tn: int, n_channels: int) -> DataLayout:
    """The paper's *base* layout: row-major, no distribution — the whole matrix
    is a single block on channel 0 (the Baseline w/o Optimal Layout in Fig. 7a)."""
    return DataLayout(SplitScheme(1, 1), PlacementScheme(tm, tn), n_channels)


def optimal_layout(shape: Tuple[int, int], tm: int, tn: int, n_channels: int) -> DataLayout:
    """Round-robin every tile-granular block over all channels — the 'optimized
    layout' the paper reports: split grid == tile grid so consecutive fetches
    hit distinct channels."""
    m, n = shape
    return DataLayout(SplitScheme(max(1, m // tm), max(1, n // tn)),
                      PlacementScheme(tm, tn), n_channels)


def candidate_layouts(shape: Tuple[int, int], tm: int, tn: int,
                      n_channels: int) -> List[DataLayout]:
    """Layout search space for the autotuner: power-of-2 split grids between
    base (1x1) and tile-granular, all channel phases collapsed to 0 (phase only
    matters when two operands collide — handled at schedule level)."""
    m, n = shape
    max_gm, max_gn = max(1, m // tm), max(1, n // tn)
    cands = []
    gm = 1
    while gm <= max_gm:
        gn = 1
        while gn <= max_gn:
            if m % gm == 0 and n % gn == 0:
                bm, bn = m // gm, n // gn
                if bm % tm == 0 and bn % tn == 0:
                    cands.append(DataLayout(SplitScheme(gm, gn),
                                            PlacementScheme(tm, tn), n_channels))
            gn *= 2
        gm *= 2
    return cands


def pack_preload(matrix: np.ndarray, layout: DataLayout,
                 elem_bytes: int) -> Dict[int, np.ndarray]:
    """Build the preload image: per-channel flat byte arrays with every tile at
    the address `tile_address` reports. This is the 'Preload' workflow stage
    (§2.3) — the simulator initializes its HBM channels from this."""
    m, n = matrix.shape
    tm, tn = layout.placement.tm, layout.placement.tn
    per_channel: Dict[int, bytearray] = {c: bytearray() for c in range(layout.n_channels)}
    # first pass: compute sizes
    sizes: Dict[int, int] = {c: 0 for c in range(layout.n_channels)}
    tile_bytes = tm * tn * elem_bytes
    for ti in range(m // tm):
        for tj in range(n // tn):
            ch, off = layout.tile_address(ti, tj, (m, n), elem_bytes)
            sizes[ch] = max(sizes[ch], off + tile_bytes)
    images = {c: np.zeros(sizes[c], dtype=np.uint8) for c in range(layout.n_channels) if sizes[c]}
    for ti in range(m // tm):
        for tj in range(n // tn):
            ch, off = layout.tile_address(ti, tj, (m, n), elem_bytes)
            tile = np.ascontiguousarray(matrix[ti * tm:(ti + 1) * tm, tj * tn:(tj + 1) * tn])
            images[ch][off:off + tile_bytes] = tile.view(np.uint8).reshape(-1)
    return images


def unpack_preload(images: Dict[int, np.ndarray], layout: DataLayout,
                   shape: Tuple[int, int], dtype: np.dtype) -> np.ndarray:
    """Inverse of pack_preload — used to read C back out of simulated HBM."""
    m, n = shape
    tm, tn = layout.placement.tm, layout.placement.tn
    elem_bytes = np.dtype(dtype).itemsize
    tile_bytes = tm * tn * elem_bytes
    out = np.zeros(shape, dtype=dtype)
    for ti in range(m // tm):
        for tj in range(n // tn):
            ch, off = layout.tile_address(ti, tj, shape, elem_bytes)
            raw = images[ch][off:off + tile_bytes]
            out[ti * tm:(ti + 1) * tm, tj * tn:(tj + 1) * tn] = (
                raw.view(dtype).reshape(tm, tn))
    return out
