"""BSP superstep IR (paper §3.3.3 + §2.2).

The paper specifies dataflow schedules as BSP supersteps, each containing
computation (on L1-resident data), communication (NoC or HBM), and a barrier;
the DaCe SDFG then captures per-PE data movement explicitly. Here the two are
merged into one IR: a `Program` is a list of `Superstep`s whose ops name the
exact tile, L1 buffer and double-buffer slot they touch — enough for both the
functional executor and the performance model in `repro_torch.sim`.

BSP semantics: within a superstep, computation reads the L1 state produced by
*previous* supersteps; communication issued in a superstep becomes visible
after its barrier. Double buffering (§3.3.1) is encoded exactly the way the
paper describes — each op names the buffer slot it uses, so a superstep can
compute on slot `s` while its DMA/multicast fills slot `1 - s`.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Tuple

from repro_torch.core.layout import DataLayout
from repro_torch.core.masks import TileGroup

Coord = Tuple[int, int]

# Canonical element-dtype name -> byte width for every dtype a deployment can
# declare. The byte-keyed legacy map (`core.schedule.DTYPE_OF_BYTES`)
# conflates elem_bytes=1 with int8 and 2 with float16; this name-keyed map is
# the authoritative direction — fp8 (float8_e4m3, the GH200 preset's engine
# dtype) and bfloat16 price and lower under their real names. numpy cannot
# parse "float8_e4m3"/"bfloat16" without ml_dtypes, so every byte-width
# lookup on dtype *names* must go through here first.
ELEM_BYTES_OF_DTYPE = {
    "int8": 1,
    "float8_e4m3": 1,
    "float16": 2,
    "bfloat16": 2,
    "float32": 4,
}


# ---------------------------------------------------------------------------
# Ops
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class DMAOp:
    """HBM <-> L1 transfer executed by one tile's DMA engine."""
    tile: Coord
    kind: str                   # 'load' | 'store'
    matrix: str                 # 'A' | 'B' | 'C'
    tile_coord: Coord           # (ti, tj) tile index within the matrix
    buf: str                    # destination/source L1 buffer name
    slot: int = 0               # double-buffer slot
    accumulate: bool = False    # store with += (split-K commit)


@dataclasses.dataclass(frozen=True)
class MulticastOp:
    """Hardware NoC multicast: src tile's L1 buffer -> every group member."""
    src: Coord
    group: TileGroup
    buf: str                    # buffer name (same on src and destinations)
    slot: int = 0
    dst_buf: Optional[str] = None   # defaults to buf
    dst_slot: Optional[int] = None  # defaults to slot
    # the multicast consumes data DMA'd in the SAME superstep (owner fetch ->
    # fabric multicast chaining); the cost model serializes DMA + NoC then.
    after_dma: bool = False


@dataclasses.dataclass(frozen=True)
class ReduceOp:
    """Hardware NoC reduction: sum of group members' buffers -> dst tile."""
    group: TileGroup
    dst: Coord
    buf: str
    slot: int = 0
    dst_buf: Optional[str] = None


@dataclasses.dataclass(frozen=True)
class P2POp:
    """Nearest-neighbour send (systolic propagation). src == dst is a local
    L1-to-L1 copy (slice feed), priced at L1 bandwidth by the cost model."""
    src: Coord
    dst: Coord
    buf: str
    slot: int = 0
    dst_slot: Optional[int] = None  # defaults to slot
    dst_buf: Optional[str] = None   # defaults to buf


@dataclasses.dataclass(frozen=True)
class MMADOp:
    """Matrix-multiply-add on one tile's matrix engine: acc += a @ b."""
    tile: Coord
    a_buf: str
    a_slot: int
    b_buf: str
    b_slot: int
    acc_buf: str = "C"
    acc_slot: int = 0
    init: bool = False          # first k-step: overwrite the accumulator
    # logical tile dims, for the cost model (may differ per op in ragged cases)
    tm: int = 0
    tn: int = 0
    tk: int = 0


CommOp = (DMAOp, MulticastOp, ReduceOp, P2POp)


@dataclasses.dataclass
class Superstep:
    """One BSP superstep: compute || communicate, then barrier."""
    compute: List[MMADOp] = dataclasses.field(default_factory=list)
    comm: List[object] = dataclasses.field(default_factory=list)
    label: str = ""


@dataclasses.dataclass
class BufferDecl:
    """L1 buffer declaration: `slots` copies of `shape` in every tile."""
    name: str
    shape: Tuple[int, int]
    slots: int = 1
    dtype: str = "float32"

    @property
    def bytes_per_slot(self) -> int:
        eb = ELEM_BYTES_OF_DTYPE.get(self.dtype)
        if eb is None:
            import numpy as np
            eb = np.dtype(self.dtype).itemsize
        return int(self.shape[0] * self.shape[1] * eb)


@dataclasses.dataclass
class Program:
    """A complete deployment: metadata + L1 buffer plan + supersteps."""
    grid: Coord                             # physical tile grid
    shape: Tuple[int, int, int]             # GEMM (M, N, K)
    tile_shape: Tuple[int, int, int]        # (TM, TN, TK)
    buffers: Dict[str, BufferDecl]
    layouts: Dict[str, DataLayout]          # per matrix 'A' | 'B' | 'C'
    supersteps: List[Superstep] = dataclasses.field(default_factory=list)
    double_buffer: bool = True
    name: str = ""
    elem_bytes: int = 4          # deployment element size (A/B operands, C commit)

    def add(self, step: Superstep) -> None:
        self.supersteps.append(step)

    # -- sanity checks -------------------------------------------------------

    def l1_bytes_per_tile(self) -> int:
        return sum(b.bytes_per_slot * b.slots for b in self.buffers.values())

    def validate(self, l1_capacity: Optional[int] = None) -> None:
        rows, cols = self.grid
        for step in self.supersteps:
            for op in step.compute:
                if not (0 <= op.tile[0] < rows and 0 <= op.tile[1] < cols):
                    raise ValueError(f"MMAD on out-of-grid tile {op.tile}")
                for buf in (op.a_buf, op.b_buf, op.acc_buf):
                    if buf not in self.buffers:
                        raise ValueError(f"MMAD references undeclared buffer {buf!r}")
            for op in step.comm:
                if isinstance(op, DMAOp) and op.buf not in self.buffers:
                    raise ValueError(f"DMA references undeclared buffer {op.buf!r}")
                if isinstance(op, MulticastOp) and op.buf not in self.buffers:
                    raise ValueError(f"multicast references undeclared buffer {op.buf!r}")
        if l1_capacity is not None:
            used = self.l1_bytes_per_tile()
            if used > l1_capacity:
                raise ValueError(
                    f"L1 plan uses {used} bytes/tile > capacity {l1_capacity} "
                    f"(buffers: { {k: (v.shape, v.slots) for k, v in self.buffers.items()} })")

    # -- statistics (used by tests and the cost model) ------------------------

    def op_counts(self) -> Dict[str, int]:
        counts: Dict[str, int] = {"mmad": 0, "dma_load": 0, "dma_store": 0,
                                  "multicast": 0, "reduce": 0, "p2p": 0}
        for step in self.supersteps:
            counts["mmad"] += len(step.compute)
            for op in step.comm:
                if isinstance(op, DMAOp):
                    counts["dma_load" if op.kind == "load" else "dma_store"] += 1
                elif isinstance(op, MulticastOp):
                    counts["multicast"] += 1
                elif isinstance(op, ReduceOp):
                    counts["reduce"] += 1
                elif isinstance(op, P2POp):
                    counts["p2p"] += 1
        return counts

    def total_flops(self) -> int:
        return sum(2 * op.tm * op.tn * op.tk
                   for step in self.supersteps for op in step.compute)

    def hbm_bytes(self, elem_bytes: int = 4) -> int:
        """Total HBM traffic (loads + stores) implied by the program."""
        tm, tn, tk = self.tile_shape
        sizes = {"A": tm * tk, "B": tk * tn, "C": tm * tn}
        total = 0
        for step in self.supersteps:
            for op in step.comm:
                if isinstance(op, DMAOp):
                    total += sizes[op.matrix] * elem_bytes
        return total
