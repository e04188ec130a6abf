"""SoftHier performance model (paper §2.1 'cycle-accurate analysis').

Prices a BSP `Program` on an `AcceleratorConfig`. Per superstep the three
resource classes are priced independently and combined with BSP max semantics
(compute, DMA and NoC phases overlap inside a superstep by construction —
builders emit serialized supersteps when a schedule disables double
buffering):

- **compute**: per-tile matrix-engine time. The engine is a ce_rows x ce_cols
  MAC array; an MMAD over (TM x TN x TK) issues ceil(TM/ce_rows) *
  ceil(TN/ce_cols) output chunks, each pipelined over TK with a
  (ce_rows + ce_cols)-cycle fill — this reproduces the paper's observation
  that TN = 66 tiles reach only ~50% engine utilization while TN = 528 tiles
  are efficient (§4.1.3). L1 feed bandwidth is a secondary bound.
- **DMA**: HBM-channel contention. Each DMA's bytes land on the channel given
  by the matrix's DataLayout; a superstep's DMA time is the busiest channel's
  bytes / channel_bw (channels operate in parallel — exactly why the paper's
  optimized split scheme helps) plus the busiest tile's L1 port time.
- **NoC**: collectives are priced on a dimension-ordered multicast/reduce tree
  (vertical distribution on the source column + horizontal distribution along
  each spanned row); every spanned link resource accumulates bytes and the
  busiest resource bounds the phase. P2P ops charge the links on their
  dimension-ordered route. Hardware collectives traverse links once —
  the mask-based broadcast of §2.1.

The model is an analytical prior (no RTL); all constants come from
`AcceleratorConfig`. `sim/calibrate.py` fits measured per-resource scale
factors on top of it — `PerfReport.calibrated(profile)` rescales a report by
a fitted `CalibrationProfile`, turning the prior into a per-hardware
predictor the autotuner can trust.
"""
from __future__ import annotations

import dataclasses
import functools
import math
from typing import Dict, Iterable, Iterator, List, Optional, Tuple

from repro_torch.core.ir import (ELEM_BYTES_OF_DTYPE, DMAOp, MMADOp, MulticastOp,
                           P2POp, Program, ReduceOp)
from repro_torch.core.masks import TileGroup
from repro_torch.core.schedule import InnerKernel
from repro_torch.hw.config import AcceleratorConfig


@functools.lru_cache(maxsize=16384)
def _members(group: TileGroup, grid: Tuple[int, int]) -> Tuple[Tuple[int, int], ...]:
    return tuple(group.members(grid))


@dataclasses.dataclass
class PerfReport:
    total_time: float
    compute_time: float
    dma_time: float
    noc_time: float
    barrier_time: float
    total_flops: int
    hbm_bytes: int
    noc_bytes: int
    n_supersteps: int
    # digest of the CalibrationProfile whose measured scale factors rescaled
    # this report ("" = the raw analytical prior; see sim/calibrate.py).
    calibration: str = ""

    @property
    def achieved_flops(self) -> float:
        return self.total_flops / self.total_time if self.total_time else 0.0

    def utilization(self, hw: AcceleratorConfig) -> float:
        return self.achieved_flops / hw.peak_flops

    @property
    def intensity(self) -> float:
        return self.total_flops / self.hbm_bytes if self.hbm_bytes else math.inf

    def bw_utilization(self, hw: AcceleratorConfig) -> float:
        return (self.hbm_bytes / self.total_time) / hw.hbm.total_bw if self.total_time else 0.0

    def to_dict(self) -> Dict[str, float]:
        """Flat JSON-able form (stable field set — part of the plan schema)."""
        return dataclasses.asdict(self)

    @classmethod
    def from_dict(cls, d: Dict[str, float]) -> "PerfReport":
        return cls(**d)

    def resource_shares(self) -> Tuple[float, float, float]:
        """(compute, dma, noc) fractions of the busy time — how this report
        attributes its total to the three resource classes. The calibration
        layer's feature vector is `total_time * shares` (so identity scale
        factors reproduce `total_time` exactly)."""
        busy = self.compute_time + self.dma_time + self.noc_time
        if busy <= 0.0:
            return (1.0, 0.0, 0.0)
        return (self.compute_time / busy, self.dma_time / busy,
                self.noc_time / busy)

    def calibrated(self, profile) -> "PerfReport":
        """This report rescaled by a fitted `CalibrationProfile`.

        Each resource component is multiplied by its measured scale factor
        and `total_time` becomes the profile's prediction (clamped so the
        superstep invariant total >= max(component, barrier) survives any
        scale combination). An identity profile returns an identical report
        apart from the recorded calibration digest.
        """
        c = self.compute_time * profile.compute_scale
        d = self.dma_time * profile.dma_scale
        n = self.noc_time * profile.noc_scale
        total = max(profile.predict(self), c, d, n, self.barrier_time)
        return dataclasses.replace(self, total_time=total, compute_time=c,
                                   dma_time=d, noc_time=n,
                                   calibration=profile.digest())

    def summary(self, hw: AcceleratorConfig) -> str:
        return (f"time={self.total_time*1e6:.1f}us "
                f"TFLOPS={self.achieved_flops/1e12:.1f} "
                f"util={self.utilization(hw)*100:.1f}% "
                f"AI={self.intensity:.1f} "
                f"bw={self.bw_utilization(hw)*100:.1f}% "
                f"steps={self.n_supersteps}")


def _engine_time(op: MMADOp, hw: AcceleratorConfig,
                 inner: Optional[InnerKernel] = None) -> float:
    """Per-tile matrix-engine time for one MMAD, optionally under a tuned
    `InnerKernel`.

    `inner=None` is the legacy single-level model (XLA/firmware picks the
    intra-tile loop): one pipeline fill per output chunk, operands fed at the
    hardware's native element width.

    With an inner kernel the geometry terms become visible to the planner:

    - **MXU occupancy**: the (tm x tn) tile splits into ceil(tm/bm) *
      ceil(tn/bn) blocks, each issuing ceil(bm/ce_rows) * ceil(bn/ce_cols)
      engine passes — a bm/bn misaligned with the CE array wastes array rows
      exactly as the paper's §4.1.3 TN=66 case does.
    - **accumulator-flush / pipeline-fill amortization vs bk**: each block
      runs ceil(tk/bk) K-chunks; a double-buffered pipeline (depth >= 2)
      pays the (ce_rows + ce_cols)-cycle fill once per engine pass, while a
      serialized pipeline (depth 1) re-fills every K-chunk AND exposes the
      L1 feed time instead of hiding it behind compute.
    - **fp8-aware feed**: operands stream at the *kernel's* element width, so
      a narrower compute dtype relieves a feed-bound tile (the paper's
      1979 TFLOPS@FP8 headline is exactly this term at full scale).

    An aligned kernel (bm | tm with ce_rows | bm, ditto bn, bk == tk,
    depth >= 2, dtype at the native width) prices EXACTLY like the legacy
    model — candidate sweeps tie instead of fabricating a difference.
    """
    t = hw.tile
    fill = t.ce_rows + t.ce_cols
    if inner is None:
        chunks = math.ceil(op.tm / t.ce_rows) * math.ceil(op.tn / t.ce_cols)
        cycles = chunks * (op.tk + fill)
        engine = cycles / t.clock_hz
        feed_bytes = (op.tm * op.tk + op.tk * op.tn) * t.elem_bytes
        return max(engine, feed_bytes / t.l1_bw)

    blocks = math.ceil(op.tm / inner.bm) * math.ceil(op.tn / inner.bn)
    sub = (math.ceil(min(inner.bm, op.tm) / t.ce_rows)
           * math.ceil(min(inner.bn, op.tn) / t.ce_cols))
    kchunks = math.ceil(op.tk / inner.bk)
    fills = fill if inner.depth >= 2 else kchunks * fill
    cycles = blocks * sub * (kchunks * inner.bk + fills)
    engine = cycles / t.clock_hz
    eb = ELEM_BYTES_OF_DTYPE.get(inner.dtype, t.elem_bytes)
    feed = (op.tm * op.tk + op.tk * op.tn) * eb / t.l1_bw
    return max(engine, feed) if inner.depth >= 2 else engine + feed


# -- two-phase estimation ----------------------------------------------------
# Communication pricing (DMA channel contention, NoC link trees, barrier) is
# independent of the inner kernel; only the compute phase changes. The sweep
# over inner-kernel candidates in `price_candidates` therefore runs the
# expensive comm pass ONCE per program and recombines per kernel.

@dataclasses.dataclass
class _StepProfile:
    comp: List[Tuple[Tuple[int, int], Tuple[int, int, int]]]  # (tile, dims)
    d_time: float
    n_time: float
    chained: bool


@dataclasses.dataclass
class _CommProfile:
    steps: List[_StepProfile]
    barrier: float
    flops: int
    hbm_bytes: int
    noc_bytes: int


def _comm_profile(prog: Program, hw: AcceleratorConfig) -> _CommProfile:
    grid = prog.grid
    barrier = (grid[0] + grid[1]) * hw.noc.hop_latency_cycles / hw.tile.clock_hz

    flops = 0
    hbm_bytes = 0
    noc_bytes = 0
    steps: List[_StepProfile] = []

    buf_bytes = {}
    for name, decl in prog.buffers.items():
        eb = ELEM_BYTES_OF_DTYPE.get(decl.dtype)
        if eb is None:
            raise KeyError(f"buffer {name!r} has unpriceable dtype "
                           f"{decl.dtype!r}; add it to ELEM_BYTES_OF_DTYPE")
        buf_bytes[name] = decl.shape[0] * decl.shape[1] * eb

    for step in prog.supersteps:
        # -- compute phase: record op dims, priced later per inner kernel
        comp: List[Tuple[Tuple[int, int], Tuple[int, int, int]]] = []
        for op in step.compute:
            comp.append((op.tile, (op.tm, op.tn, op.tk)))
            flops += 2 * op.tm * op.tn * op.tk

        # -- DMA phase: channel + L1-port contention
        chan_bytes: Dict[int, int] = {}
        tile_bytes: Dict[Tuple[int, int], int] = {}
        # -- NoC phase: link-resource contention
        row_res: Dict[int, int] = {}
        col_res: Dict[int, int] = {}
        link_res: Dict[Tuple[Tuple[int, int], Tuple[int, int]], int] = {}
        local_res: Dict[Tuple[int, int], int] = {}
        max_hop_lat = 0.0

        for op in step.comm:
            if isinstance(op, DMAOp):
                if op.matrix == "C":
                    # C commits at the deployment element size (the L1
                    # accumulator stays fp32, so buf_bytes would overcount).
                    tm, tn, _ = prog.tile_shape
                    nbytes = tm * tn * prog.elem_bytes
                else:
                    nbytes = buf_bytes[op.buf]
                layout = prog.layouts[op.matrix]
                mshape = _matrix_shape(prog, op.matrix)
                ch = layout.channel_of_tile(*op.tile_coord, mshape)
                chan_bytes[ch] = chan_bytes.get(ch, 0) + nbytes
                tile_bytes[op.tile] = tile_bytes.get(op.tile, 0) + nbytes
                hbm_bytes += nbytes
            elif isinstance(op, (MulticastOp, ReduceOp)):
                nbytes = buf_bytes[op.buf]
                anchor = op.src if isinstance(op, MulticastOp) else op.dst
                members = _members(op.group, grid)
                rows = sorted({i for i, _ in members})
                cols = sorted({j for _, j in members})
                # dimension-ordered tree: vertical leg on the anchor column,
                # horizontal leg along each spanned row.
                if len(rows) > 1:
                    col_res[anchor[1]] = col_res.get(anchor[1], 0) + nbytes
                if len(cols) > 1:
                    for r in rows:
                        row_res[r] = row_res.get(r, 0) + nbytes
                hops = (rows[-1] - rows[0]) + (cols[-1] - cols[0])
                max_hop_lat = max(max_hop_lat,
                                  hops * hw.noc.hop_latency_cycles / hw.tile.clock_hz)
                noc_bytes += nbytes * max(1, len(members) - 1)
            elif isinstance(op, P2POp):
                nbytes = buf_bytes[op.buf]
                if op.src == op.dst:
                    local_res[op.src] = local_res.get(op.src, 0) + nbytes
                    continue
                # dimension-ordered route: along the row, then the column
                (si, sj), (di, dj) = op.src, op.dst
                for j in range(min(sj, dj), max(sj, dj)):
                    link_res[((si, j), (si, j + 1))] = \
                        link_res.get(((si, j), (si, j + 1)), 0) + nbytes
                for i in range(min(si, di), max(si, di)):
                    link_res[((i, dj), (i + 1, dj))] = \
                        link_res.get(((i, dj), (i + 1, dj)), 0) + nbytes
                hops = abs(si - di) + abs(sj - dj)
                max_hop_lat = max(max_hop_lat,
                                  hops * hw.noc.hop_latency_cycles / hw.tile.clock_hz)
                noc_bytes += nbytes
            else:
                raise TypeError(f"unknown comm op {type(op)}")

        d_time = 0.0
        if chan_bytes:
            d_time = max(b / hw.hbm.channel_bw for b in chan_bytes.values())
        if tile_bytes:
            d_time = max(d_time, max(b / hw.tile.l1_bw for b in tile_bytes.values()))
        n_time = 0.0
        for res in (row_res, col_res):
            if res:
                n_time = max(n_time, max(b / hw.noc.link_bw for b in res.values()))
        if link_res:
            n_time = max(n_time, max(b / hw.noc.link_bw for b in link_res.values()))
        if local_res:
            n_time = max(n_time, max(b / hw.tile.l1_bw for b in local_res.values()))
        n_time += max_hop_lat

        # a multicast chained off a same-superstep owner DMA serializes the
        # DMA and NoC phases (fetch -> fabric multicast dependency).
        chained = any(isinstance(op, MulticastOp) and op.after_dma for op in step.comm)
        steps.append(_StepProfile(comp=comp, d_time=d_time, n_time=n_time,
                                  chained=chained))

    return _CommProfile(steps=steps, barrier=barrier, flops=flops,
                        hbm_bytes=hbm_bytes, noc_bytes=noc_bytes)


def _combine(prog: Program, hw: AcceleratorConfig, profile: _CommProfile,
             inner: Optional[InnerKernel]) -> PerfReport:
    """Recombine a comm profile with the compute phase under one inner
    kernel. With `inner=None` this reproduces the single-pass estimate
    bit-identically (same op order, same float additions)."""
    tot = comp_t = dma_t = noc_t = 0.0
    etime: Dict[Tuple[int, int, int], float] = {}
    for step in profile.steps:
        per_tile: Dict[Tuple[int, int], float] = {}
        for tile, dims in step.comp:
            e = etime.get(dims)
            if e is None:
                tm, tn, tk = dims
                e = etime[dims] = _engine_time(
                    MMADOp(tile=tile, a_buf="A", a_slot=0, b_buf="B",
                           b_slot=0, tm=tm, tn=tn, tk=tk), hw, inner)
            per_tile[tile] = per_tile.get(tile, 0.0) + e
        c_time = max(per_tile.values(), default=0.0)
        comm_time = (step.d_time + step.n_time if step.chained
                     else max(step.d_time, step.n_time))
        tot += max(c_time, comm_time) + profile.barrier
        comp_t += c_time
        dma_t += step.d_time
        noc_t += step.n_time

    return PerfReport(total_time=tot, compute_time=comp_t, dma_time=dma_t,
                      noc_time=noc_t,
                      barrier_time=profile.barrier * len(profile.steps),
                      total_flops=profile.flops,
                      hbm_bytes=profile.hbm_bytes,
                      noc_bytes=profile.noc_bytes,
                      n_supersteps=len(profile.steps))


def estimate(prog: Program, hw: AcceleratorConfig,
             inner: Optional[InnerKernel] = None) -> PerfReport:
    return _combine(prog, hw, _comm_profile(prog, hw), inner)


def estimate_sweep(prog: Program, hw: AcceleratorConfig,
                   inners: Iterable[Optional[InnerKernel]]
                   ) -> Iterator[Tuple[Optional[InnerKernel], PerfReport]]:
    """Price one program under several inner kernels, running the expensive
    communication pass once. Yields (inner, report) in the given order —
    callers that keep the first strict minimum therefore inherit the
    sweep's tie-break ordering."""
    profile = _comm_profile(prog, hw)
    for inner in inners:
        yield inner, _combine(prog, hw, profile, inner)


def _matrix_shape(prog: Program, matrix: str) -> Tuple[int, int]:
    m, n, k = prog.shape
    return {"A": (m, k), "B": (k, n), "C": (m, n)}[matrix]


# -- fused attention (FlatAttention) ------------------------------------------

def _attn_gemm_time(tm: int, tn: int, tk: int, hw: AcceleratorConfig) -> float:
    """Engine cycles for one (tm x tn x tk) contraction, legacy model (the
    fused dataflow has no inner kernel — softmax sits between the two
    contractions, so the Pallas mmad pipeline does not apply)."""
    t = hw.tile
    fill = t.ce_rows + t.ce_cols
    chunks = math.ceil(tm / t.ce_rows) * math.ceil(tn / t.ce_cols)
    return chunks * (tk + fill)


def estimate_attention(sched, hw: AcceleratorConfig,
                       head_shard: Optional[bool] = None) -> PerfReport:
    """Price an `AttnSchedule` on `hw` with the same BSP superstep semantics
    as `estimate`: per superstep the busiest resource bounds the phase, plus
    a grid barrier; components accumulate so `resource_shares` (and hence
    `CalibrationProfile.predict`) rescales attention exactly like GEMMs.

    One superstep streams one `kv_chunk`-wide KV tile through L1: QKᵀ
    (sq_l x chunk x d), ~4 vector passes over the logits for the online
    softmax (max, exp, row-sum, rescale), then PV (sq_l x dv x chunk).

    - **merge**: KV row-sharded; every device scans its local KV, then ONE
      combine superstep pmax/psum-reduces the (m, l, acc) partials over the
      row axis.
    - **ring**: Q additionally row-sharded; the local KV shard rotates
      around a ppermute ring, so each device runs dm passes and each step's
      NoC phase carries the KV block to the next neighbour.

    The caller guarantees lowering legality (skv % dm == 0; ring also
    sq % dm == 0) — `attn_candidates` only emits legal schedules and
    `lower_attention` re-checks at dispatch.
    """
    shp = sched.shape
    dm, dn = hw.grid
    eb = sched.elem_bytes
    if head_shard is None:
        head_shard = (dn > 1 and shp.h % dn == 0
                      and (shp.hkv % dn == 0 or shp.hkv == 1))
    h_l = shp.h // dn if head_shard else shp.h
    hkv_l = shp.hkv // dn if (head_shard and shp.hkv % dn == 0) else shp.hkv
    ring = sched.composition == "ring" and dm > 1
    kv_l = max(1, shp.skv // max(1, dm))
    sq_l = max(1, shp.sq // dm) if ring else shp.sq
    chunk = max(1, min(sched.kv_chunk, kv_l))
    steps_per_pass = math.ceil(kv_l / chunk)
    passes = dm if ring else 1
    n_steps = steps_per_pass * passes

    t = hw.tile
    # compute phase: both contractions + the softmax's vector passes, per
    # (batch, local head), one KV chunk per superstep
    cycles = (_attn_gemm_time(sq_l, chunk, shp.d, hw)
              + _attn_gemm_time(sq_l, shp.dv, chunk, hw)
              + 4 * sq_l * chunk)
    engine = shp.b * h_l * cycles / t.clock_hz
    feed = shp.b * (h_l * sq_l * shp.d + hkv_l * chunk * (shp.d + shp.dv)) * eb
    comp_step = max(engine, feed / t.l1_bw)

    # DMA phase: Q in + O out once, the local KV shard streamed once per
    # pass; balanced channel layout, so the busiest channel carries the
    # per-device share (global bytes / total HBM bandwidth)
    q_bytes = shp.b * shp.sq * shp.h * shp.d * eb
    o_bytes = shp.b * shp.sq * shp.h * shp.dv * eb
    kv_bytes = shp.b * shp.skv * shp.hkv * (shp.d + shp.dv) * eb
    hbm_bytes = q_bytes + o_bytes + kv_bytes * passes
    dma_total = hbm_bytes / hw.hbm.total_bw
    dma_step = dma_total / n_steps

    hop = hw.noc.hop_latency_cycles / t.clock_hz
    barrier = (dm + dn) * hop

    if ring:
        # each step also rotates the KV shard one hop around the ring
        block = shp.b * kv_l * hkv_l * (shp.d + shp.dv) * eb
        noc_step = block / hw.noc.link_bw + hop
        noc_bytes = block * max(0, dm - 1)
        total = n_steps * (max(comp_step, dma_step, noc_step) + barrier)
        noc_time = noc_step * n_steps
        n_supersteps = n_steps
    else:
        # scan supersteps, then one combine superstep reducing the fp32
        # (m, l, acc) partials over the dm-member row tree
        partial = shp.b * h_l * sq_l * (2 + shp.dv) * 4
        noc_time = partial / hw.noc.link_bw + max(0, dm - 1) * hop
        noc_bytes = partial * max(0, dm - 1)
        total = (n_steps * (max(comp_step, dma_step) + barrier)
                 + (noc_time + barrier if dm > 1 else 0.0))
        n_supersteps = n_steps + (1 if dm > 1 else 0)
        if dm <= 1:
            noc_time = 0.0

    compute_time = comp_step * n_steps
    report = PerfReport(total_time=max(total, compute_time, dma_total,
                                       noc_time, barrier),
                        compute_time=compute_time, dma_time=dma_total,
                        noc_time=noc_time,
                        barrier_time=barrier * n_supersteps,
                        total_flops=shp.flops(), hbm_bytes=hbm_bytes,
                        noc_bytes=noc_bytes, n_supersteps=n_supersteps)
    return report
