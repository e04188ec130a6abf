"""Hardware configuration for tile-based many-PE accelerators (SoftHier template),
the TPU pod view the planner prices plans on over a CPU mesh, and the H100:
the data sheet the dry run's roofline reports against, and the card view
the planner prices plans on over a CUDA mesh.

The paper (Table 1) instantiates SoftHier to match an NVIDIA GH200:
  32x32 tiles, 4096-bit NoC links, 32x2 HBM channels on west/south edges,
  per-tile matrix engine 64x16 CE array @ 1.93 TFLOPS FP8, 384 KB L1 @ 512 GB/s,
  totals: 1979 TFLOPS peak, 4 TB/s HBM.

Everything here is a plain dataclass so instances are hashable config values that
can parameterize the cost model, the simulator, and schedule legality checks.
"""
from __future__ import annotations

import dataclasses
from typing import NamedTuple, Tuple


@dataclasses.dataclass(frozen=True)
class TileConfig:
    """One compute tile: matrix engine + local scratchpad."""
    # matrix engine: systolic array of ce_rows x ce_cols compute elements.
    ce_rows: int = 64
    ce_cols: int = 16
    # peak throughput of the tile's matrix engine, FLOP/s (2 flops per MAC).
    peak_flops: float = 1.93e12
    # local L1 scratchpad (software managed), bytes and bandwidth.
    l1_bytes: int = 384 * 1024
    l1_bw: float = 512e9
    # element size the engine natively computes in (fp8 in the paper's GH200 config).
    elem_bytes: int = 1
    # element dtype name the engine natively computes in. Disambiguates the
    # byte width (1 byte = fp8 here, not int8; 2 bytes = bf16 on TPU, not
    # fp16). "" means "no native preference" — pricing/lowering fall back to
    # the legacy byte-width default. Accumulation is fp32 regardless.
    elem_dtype: str = "float8_e4m3"

    @property
    def macs_per_cycle(self) -> int:
        return self.ce_rows * self.ce_cols

    @property
    def clock_hz(self) -> float:
        # peak_flops = 2 * macs_per_cycle * clock
        return self.peak_flops / (2.0 * self.macs_per_cycle)


@dataclasses.dataclass(frozen=True)
class NoCConfig:
    """Programmable network-on-chip with hardware collective support."""
    link_bits: int = 4096
    # per-link bandwidth in bytes/s; the paper gives link width, we derive
    # bytes/cycle * clock of the fabric (assume fabric clocked with tiles).
    link_bw: float = 4096 / 8 * 1e9  # 512 GB/s per link at 1 GHz
    # hardware collective primitives available (mask-based multicast/reduce).
    hw_collectives: bool = True
    # per-hop latency in cycles (used by the systolic model).
    hop_latency_cycles: int = 4


@dataclasses.dataclass(frozen=True)
class HBMConfig:
    """Distributed HBM channels along the grid edges."""
    n_channels: int = 64          # 32x2 in the paper
    channel_bw: float = 64e9      # 4 TB/s / 64 channels
    # which edges carry channels; affects NoC distance in the contention model.
    edges: Tuple[str, ...] = ("west", "south")

    @property
    def total_bw(self) -> float:
        return self.n_channels * self.channel_bw


@dataclasses.dataclass(frozen=True)
class AcceleratorConfig:
    """A full SoftHier-template instance: grid of tiles + NoC + HBM."""
    name: str
    grid: Tuple[int, int] = (32, 32)
    tile: TileConfig = TileConfig()
    noc: NoCConfig = NoCConfig()
    hbm: HBMConfig = HBMConfig()

    @property
    def n_tiles(self) -> int:
        return self.grid[0] * self.grid[1]

    @property
    def peak_flops(self) -> float:
        return self.n_tiles * self.tile.peak_flops

    @property
    def ridge_intensity(self) -> float:
        """FLOP/byte at which the roofline transitions memory->compute bound."""
        return self.peak_flops / self.hbm.total_bw


# ---------------------------------------------------------------------------
# Paper instances (Table 1 + the portability study in §4.2)
# ---------------------------------------------------------------------------

def softhier_gh200() -> AcceleratorConfig:
    """SoftHier sized to match NVIDIA GH200: 1979 TFLOPS fp8, 4 TB/s."""
    return AcceleratorConfig(
        name="softhier-gh200",
        grid=(32, 32),
        tile=TileConfig(ce_rows=64, ce_cols=16, peak_flops=1.93e12,
                        l1_bytes=384 * 1024, l1_bw=512e9, elem_bytes=1,
                        elem_dtype="float8_e4m3"),
        noc=NoCConfig(link_bits=4096, link_bw=512e9),
        hbm=HBMConfig(n_channels=64, channel_bw=64e9),
    )


def softhier_a100() -> AcceleratorConfig:
    """SoftHier sized to match NVIDIA A100: 312 TFLOPS fp16, 1.56 TB/s (§4.2)."""
    return AcceleratorConfig(
        name="softhier-a100",
        grid=(16, 16),
        tile=TileConfig(ce_rows=32, ce_cols=16, peak_flops=312e12 / 256,
                        l1_bytes=256 * 1024, l1_bw=512e9, elem_bytes=2,
                        elem_dtype="float16"),
        noc=NoCConfig(link_bits=2048, link_bw=256e9),
        hbm=HBMConfig(n_channels=32, channel_bw=1.56e12 / 32),
    )


# ---------------------------------------------------------------------------
# TPU pod view: the grid the planner prices and tunes plans on over a CPU
# mesh (the reference's deployment target; its constants stay the TPU's so
# a plan cache is shared with the reference package).
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class TPUChipConfig:
    """TPU v5e chip constants used for the roofline terms."""
    name: str = "tpu-v5e"
    peak_flops_bf16: float = 197e12
    hbm_bw: float = 819e9
    ici_link_bw: float = 50e9
    # each chip has links to its mesh neighbours; 2D torus -> 4 links.
    ici_links: int = 4
    hbm_bytes: int = 16 * 1024 ** 3
    vmem_bytes: int = 128 * 1024 ** 2


TPU_V5E = TPUChipConfig()


def tpu_pod_as_accelerator(grid: Tuple[int, int] = (16, 16)) -> AcceleratorConfig:
    """View one TPU pod through the SoftHier template: chips are tiles, ICI is
    the NoC, per-chip HBM stacks are the distributed channels. Used to apply
    the paper's schedule abstraction / cost model at the inter-chip level."""
    c = TPU_V5E
    return AcceleratorConfig(
        name=f"tpu-v5e-{grid[0]}x{grid[1]}",
        grid=grid,
        tile=TileConfig(ce_rows=128, ce_cols=128, peak_flops=c.peak_flops_bf16,
                        l1_bytes=c.vmem_bytes, l1_bw=c.hbm_bw, elem_bytes=2,
                        elem_dtype="bfloat16"),
        noc=NoCConfig(link_bits=8 * int(c.ici_link_bw / 1e9), link_bw=c.ici_link_bw,
                      hw_collectives=True),
        hbm=HBMConfig(n_channels=grid[0] * grid[1], channel_bw=c.hbm_bw,
                      edges=("local",)),
    )


# ---------------------------------------------------------------------------
# GPU deployment target: the card the port runs on.
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class GPUChipConfig:
    """Data-sheet constants of one card: the dry run's roofline terms
    (compute, memory and collective seconds), and the constants
    `h100_as_accelerator` prices plans with on a CUDA mesh."""
    name: str
    peak_flops_bf16: float       # dense (no sparsity), FLOP/s
    hbm_bw: float                # bytes/s
    hbm_bytes: int
    nvlink_bw: float             # per card, both directions together, bytes/s
    nic_bw: float                # per card, the inter-node network, bytes/s


H100_SXM = GPUChipConfig(
    name="h100-sxm",
    # NVIDIA H100 Tensor Core GPU data sheet, SXM5: 1,979 TFLOPS bf16 with
    # sparsity, half that dense
    peak_flops_bf16=989.4e12,
    # same data sheet: HBM3, 3.35 TB/s, 80 GB
    hbm_bw=3.35e12,
    hbm_bytes=80 * 10 ** 9,
    # same data sheet: NVLink 4, 900 GB/s per card (both directions)
    nvlink_bw=900e9,
    # NVIDIA DGX H100 system specifications: one 400 Gb/s ConnectX-7 NIC
    # per card for the compute fabric, i.e. 50 GB/s
    nic_bw=400e9 / 8,
)


# ---------------------------------------------------------------------------
# H100 card view: the grid the planner prices plans on over a CUDA mesh,
# the reference's `tpu_pod_as_accelerator` with the card's constants, and
# the inner kernels the card's tensor-core kernels are compiled for.
# ---------------------------------------------------------------------------

class TensorCoreInstance(NamedTuple):
    """One geometry `mmad`'s tensor-core kernels are compiled for
    (csrc/mmad.cu): the operand family ("16bit": bf16 and fp16 share one
    kernel; "e4m3": fp8), the CTA tile (bm x bn), the K step (bk: one
    128-byte swizzle row) and the depth of the shared-memory ring."""
    family: str
    bm: int
    bn: int
    bk: int
    stages: int


# schedule dtype names -> the tensor-core family that multiplies them
TENSOR_CORE_FAMILY = {"bfloat16": "16bit", "float16": "16bit",
                      "float8_e4m3": "e4m3"}

# What csrc/mmad.cu compiles, in the order of its TC_INSTANCES table
# (kernels/mmad.py launches by this list and holds the built library's
# table to it when it loads). Each tile takes the most stages whose ring,
# 1 KB of alignment slack and two barriers a stage fit
# `core.schedule.INNER_SMEM_BUDGET`, at most six: six 64-deep steps (or
# 128-deep for e4m3) keep loads in flight as far ahead as the fp8 route's
# 128-wide ring did since it was measured (tools/mmad_fp8_times.py); a
# deeper ring only holds more shared memory.
# A family's tiles come largest first, so a pricing sweep that ties keeps
# the largest (the route's own bf16 tile, 128 x 256 x 64 with 4 stages).
H100_TC_INSTANCES = (
    TensorCoreInstance("16bit", 128, 256, 64, 4),
    TensorCoreInstance("16bit", 128, 128, 64, 6),
    TensorCoreInstance("16bit", 128, 64, 64, 6),
    TensorCoreInstance("16bit", 64, 256, 64, 5),
    TensorCoreInstance("16bit", 64, 128, 64, 6),
    TensorCoreInstance("16bit", 64, 64, 64, 6),
    TensorCoreInstance("e4m3", 128, 192, 128, 5),
    TensorCoreInstance("e4m3", 128, 128, 128, 6),
)
# rows up to which `mmad`'s stream kernels take a product whose B they can
# vector-load (kernels/mmad.py:STREAM_MAX_M): no tensor-core instance
H100_STREAM_MAX_M = 16
# the schedule dtypes the card's tensor cores take natively: a 1-byte
# schedule on the card view is e4m3, not int8
H100_NATIVE_DTYPES = ("bfloat16", "float8_e4m3")


@dataclasses.dataclass(frozen=True)
class CardViewConfig(AcceleratorConfig):
    """An `AcceleratorConfig` whose tiles are whole cards. The planner
    (`core.schedule`) and lowering (`core.lower`) read what the card's
    kernels are compiled for from the `H100_*` constants above; the one
    field added here, not settable, spells the instance list out so that
    it enters `hw_fingerprint`: a plan persisted under another list is a
    cache miss, not a kernel lowering would demote."""
    tc_instances: str = dataclasses.field(
        default=" ".join(f"{i.family}:{i.bm}x{i.bn}x{i.bk}s{i.stages}"
                         for i in H100_TC_INSTANCES), init=False)


def h100_as_accelerator(grid: Tuple[int, int] = (1, 1)) -> CardViewConfig:
    """View H100 cards through the SoftHier template, as
    `tpu_pod_as_accelerator` views a TPU pod: cards are the tiles, NVLink 4
    is the NoC, each card's HBM3 is one channel. A tile's engine is the
    card's tensor cores at their dense bf16 peak, fed from HBM (the TPU
    view feeds its `l1_bw` from HBM too), its L1 the card's HBM (where the
    outer schedule's panels live; the inner kernel's shared memory is
    `core.schedule.INNER_SMEM_BUDGET`), its CE array 64 x 64 (the M of one
    `wgmma` instruction, and its narrowest N here). NVSwitch joins the
    cards all to all, so each mesh link is priced at a card's NVLink rate
    one way, 450 GB/s, with its in-switch reductions as hardware
    collectives."""
    c = H100_SXM
    link_bw = c.nvlink_bw / 2
    return CardViewConfig(
        name=f"h100-sxm-{grid[0]}x{grid[1]}",
        grid=grid,
        tile=TileConfig(ce_rows=64, ce_cols=64, peak_flops=c.peak_flops_bf16,
                        l1_bytes=c.hbm_bytes, l1_bw=c.hbm_bw, elem_bytes=2,
                        elem_dtype="bfloat16"),
        noc=NoCConfig(link_bits=8 * int(link_bw / 1e9), link_bw=link_bw,
                      hw_collectives=True),
        hbm=HBMConfig(n_channels=grid[0] * grid[1], channel_bw=c.hbm_bw,
                      edges=("local",)),
    )


PRESETS = {
    "softhier-gh200": softhier_gh200,
    "softhier-a100": softhier_a100,
    "tpu-v5e-pod": tpu_pod_as_accelerator,
    "h100-sxm": h100_as_accelerator,
}


def get_accelerator(name: str) -> AcceleratorConfig:
    if name not in PRESETS:
        raise KeyError(f"unknown accelerator preset {name!r}; have {sorted(PRESETS)}")
    return PRESETS[name]()
