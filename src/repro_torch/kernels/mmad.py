"""The per-tile MMAD (paper Fig. 3b) as a hand-written Hopper CUDA kernel.

Replaces `repro/kernels/mmad.py:_mmad_kernel`, the Pallas TPU kernel that
streams (bm x bk) / (bk x bn) blocks HBM->VMEM over an (M/bm, N/bn, K/bk)
grid and keeps an fp32 accumulator across the sequential K axis, its
products summed by the MXU. The CUDA source is `csrc/mmad.cu`; its header
note says how the TPU design was rethought for the card.

Decode (M = batch = 4): every GEMM reads its (K, N) weight once and does 8
FLOPs per weight element, so it is bound by device-memory bytes (3.35
TB/s), not by the tensor cores. For up to 16 rows of A with a weight whose
rows (or columns) are contiguous and 16-byte aligned — every decode GEMM —
a stream kernel reads the weight once against A, staged once as fp32 in
shared memory. The row stream serves (K, N) weights: each thread loads
16-byte vectors of a 128-byte column tile straight into registers, a batch
of 8 k rows in flight while the last is summed. The column stream serves
the tied lm_head weight `embed.T`, a strided view it reads in place (a pad
or `.contiguous()` would copy 1 GB per step): one producer warp feeds a
shared-memory ring per consumer warp with 1-D bulk copies. Both fill the
card in one launch, splitting K only until the CTAs cover the SMs; a split
is summed in the same launch by the last split to arrive at its output
tile, in split order (arrival counters from `counter_buffer`, left at zero
by every launch; fp32 partials in `workspace`). `stream_geometry` is the
pure-Python mirror of that layout.

Training (M = 2048 tokens, K = 2048-16384): ~680 FLOP per byte, so the
GEMMs are bound by operations (989 TFLOPS bf16 dense), which only the
tensor cores reach. Where both operands are bf16 (or both fp16) and a TMA
tensor map can describe them (`wgmma_b_major`) — every train GEMM, forward
and backward — the tensor-core variant runs: the plan's CTA tile (by
default 128 x 256), a consumer warpgroup per 64 rows on `wgmma` with fp32
accumulators in registers, a producer thread keeping a shared-memory ring
(4 stages at 128 x 256) filled with TMA
loads, B read in place whether it is a (K, N) weight or `embed.T`, A read
in place whether it is an activation or the M-contiguous `a.T` of the
backward's weight gradient, K not split (on the card a split's fp32
partials cost more than the SMs it fills gave back).
`wgmma_geometry` is its pure-Python mirror.

The paper's fp8 GEMMs (the DeepGEMM shapes under `softhier_gh200` plans,
M = 4096 at ~200 FLOP a byte, M = 64 or 128 bound by B's bytes): where both
operands are fp8 e4m3, M exceeds `STREAM_MAX_M` and a tensor map can
describe them, A K-contiguous (`wgmma_b_major`), the fp8 tensor-core
variant runs: `wgmma` on e4m3 at twice the bf16 rate, fed by a TMA ring,
the plan's tile or, where it names none, 128 x 128 tiles for one M tile
and 128 x 192 ones for more where they take fewer waves
(`fp8_tile_width`), the tensor cores' sums (about 14
bits kept) promoted into fp32 registers every 128 k, K split for the flat
shapes until one wave fills the SMs and summed in the same launch. fp8
`wgmma` reads only K-major operands, so a (K, N) weight is first copied
K-major into the call's workspace by a transpose kernel of the same call
(`embed.T`-like K-major weights are read in place). `fp8_geometry` is its
pure-Python mirror. Everything else — fp32 and int8 inputs, fp8 the fp8
variant refuses, mixed dtypes, strides a tensor map cannot describe; on
the main path the fp32 MoE router and xLSTM gates in training — takes the
SIMT tile kernel, IEEE fp32 FMAs on the CUDA cores. A is its one large
operand and N is narrow (64 for the router, 8 for the gates), so its
instance is sized by N: narrow tiles 64 rows tall and as wide as N
rounded up to a power of two (no masked columns, A streamed once), a wide
128 x 128 tile past 64 columns; operands of one dtype whose rows are
16-byte aligned (`tile_vectors`) are copied into a shared-memory ring by
16-byte `cp.async` with the next stages in flight, and anything else
(mixed dtypes, a bf16 K of 130, `embed.T` in fp32) takes a generic
instance with scalar loads. K splits from the shape and the SM count in
whole 32-deep stages, until the CTAs fill the slots each SM keeps for the
instance, and the split is fixed up in the same launch as the stream
kernels fix theirs. `tile_geometry` is its pure-Python mirror. The route is
chosen by `plan_launch` from dtypes, strides and alignment, never by a
failed launch.

The plan's inner kernel runs on the tensor cores: `mmad(a, b,
block_shape=(bm, bn, bk), stages=s)` launches that tensor-core instance,
one of `TC_INSTANCES` (the card view's `hw.config.H100_TC_INSTANCES`,
which a plan priced on that view names), and raises `ValueError` for a
geometry outside the list or for operands the tensor cores do not take;
`block_shape=None` runs the route's own geometry. Register accumulators
need compile-time shapes, so only the listed instances are compiled; the
stream kernels' tiles, splits and rings and the SIMT tile route's instance
and split are their own. `geometry_counts()` records which geometry each
launch ran and whether the caller named it.

Dispatch is by the tensors' device and nothing else: CUDA tensors launch the
kernel or raise; CPU tensors (which only a caller that chose the CPU holds)
take the plain version in `kernels/ref.py`. `launch_count()` counts kernel
launches, so a run can show that its GEMMs went through the kernel.
"""
from __future__ import annotations

import ctypes
import functools
import math
from typing import NamedTuple, Optional, Tuple

import torch

from repro_torch.core.schedule import ring_bytes
from repro_torch.hw.config import (H100_STREAM_MAX_M, H100_TC_INSTANCES,
                                   TensorCoreInstance)
from repro_torch.kernels import ref
from repro_torch.obs.trace import profile_scope

# dtype codes shared with csrc/mmad.cu
DTYPE_CODES = {
    torch.float32: 0,
    torch.bfloat16: 1,
    torch.float16: 2,
    torch.float8_e4m3fn: 3,
    torch.int8: 4,
}
OUT_DTYPES = (torch.float32, torch.bfloat16, torch.float16)

# csrc/mmad.cu launch variants
TILE, ROW_STREAM, COL_STREAM, WGMMA, WGMMA_FP8 = 0, 1, 2, 3, 4
STREAM_MAX_M = H100_STREAM_MAX_M  # the stream variants take up to this many rows
STREAM_ROWS = 4          # rows of A per stream CTA (SK_MT)
STREAM_WARPS = 8         # consumer warps per stream CTA (SK_WARPS); +1 producer
STREAM_COLS = 4          # columns per item of the column stream (SK_COLS)
ROW_VECS = 8             # row-stream tile: 8 vectors of 16 B (ROW_VECS)
ROW_BATCH = 8            # k rows a row-stream thread has in flight (ROW_BATCH)
ROW_THREADS = STREAM_WARPS * 32  # threads per row-stream CTA (ROW_NT)
ROW_UNIT = 8             # a row-stream split is a whole number of these k
COL_STAGE_BYTES, COL_STAGES = 8192, 2      # one ring per column-stream warp
ROW_MAX_KPS, COL_MAX_KPS = 2048, 2048      # A staged once: 16 B per k
COL_CTAS_PER_SM = 1                        # __launch_bounds__ residency
# the tensor-core instances csrc/mmad.cu compiles, in the order of its
# TC_INSTANCES table (a launch names one by its index): the card view's
# list, which `_load` holds the built library's table to
TC_INSTANCES = H100_TC_INSTANCES
# the tensor-core variant (csrc/mmad.cu WG_*): the route's own CTA tile,
# K step and ring, where the caller names no instance
WGMMA_DTYPES = (torch.bfloat16, torch.float16)
WGMMA_INSTANCE = TC_INSTANCES[0]
WGMMA_BN, WGMMA_BK = WGMMA_INSTANCE.bn, WGMMA_INSTANCE.bk
WGMMA_MAX_N_TILES = 65535                  # grid.y
# the (A, B) majors the kernel is built for: the forward's activation
# against a (K, N) weight or `embed.T`, the backward's da = g @ b.T (b.T is
# K-contiguous; lm_head's is `embed`, N-contiguous) and db = a.T @ g
WGMMA_MAJORS = (("k", "n"), ("k", "k"), ("m", "n"))
# the fp8 e4m3 tensor-core variant (csrc/mmad.cu F8_*): CTA tile, K step
# (one 128-byte swizzle row of e4m3), ring, the (A, B) majors it reads
# (fp8 wgmma reads K-major operands only: an N-major B is transposed in the
# call), and the transpose kernel's tile
FP8_DTYPES = (torch.float8_e4m3fn,)
FP8_BM, FP8_BK = 128, 128
# the tile's N widths (csrc/mmad.cu F8Cfg), the ring's stages for each,
# and the rate at which a CTA of each works through its tile's columns
# (on an H100 a 128 x 192 tile's 40 KB stages fed the tensor cores ~1.2x
# faster than a 128 x 128 tile's 32 KB: tools/mmad_fp8_times.py)
FP8_BN_FLAT, FP8_BN = 128, 192
FP8_STAGES = {i.bn: i.stages for i in TC_INSTANCES if i.family == "e4m3"}
FP8_BN_RATE = {FP8_BN_FLAT: 1.0, FP8_BN: 1.2}
FP8_MAJORS = (("k", "n"), ("k", "k"))
FP8_T_K, FP8_T_N = 128, 128
FP8_MAX_T_K_TILES = 65535                  # the transpose's grid.y
# K steps between promotions of the tensor-core sums into fp32 registers
# (0: once, at the end; below 256); csrc/mmad.cu's header note says why
FP8_PROMOTE_STEPS = 1
# the SIMT tile route (csrc/mmad.cu TILE_*): threads a CTA, k a stage (and
# the unit a K split is cut in)
TILE_THREADS = 256
TILE_BK = 32


_launches = 0
# (variant, (m, n, k), tensor-core instance or None, named by the caller)
# -> launches since the last `reset_launch_count()`
_geometries = {}
_lib = None
_sm_count = {}
_counters = {}           # (device index, stream) -> int32 arrival counters
_workspaces = {}         # (device index, stream) -> fp32 split-K partials


def launch_count() -> int:
    """Kernel launches since the last `reset_launch_count()`."""
    return _launches


def geometry_counts() -> dict:
    """Launches since the last `reset_launch_count()` by (variant, (m, n,
    k), the tensor-core instance it ran or None off the tensor cores,
    whether the caller named that instance)."""
    return dict(_geometries)


def reset_launch_count() -> None:
    global _launches
    _launches = 0
    _geometries.clear()


def compiled_instances(lib: ctypes.CDLL) -> Tuple[TensorCoreInstance, ...]:
    """The tensor-core instances a loaded csrc/mmad.cu build compiled."""
    cap = 64
    out = (ctypes.c_int * (5 * cap))()
    count = lib.mmad_instances(out, cap)
    families = ("16bit", "e4m3")
    return tuple(TensorCoreInstance(families[out[5 * i]],
                                    *out[5 * i + 1:5 * i + 5])
                 for i in range(min(count, cap)))


def bind(lib: ctypes.CDLL) -> ctypes.CDLL:
    """Declare `mmad_launch`'s C signature on a loaded csrc/mmad.cu build,
    and hold the build's tensor-core instances to `TC_INSTANCES`."""
    fn = lib.mmad_launch
    fn.restype = ctypes.c_int
    fn.argtypes = ([ctypes.c_void_p] * 5 + [ctypes.c_int] * 3
                   + [ctypes.c_longlong] * 8
                   + [ctypes.c_int] * 3 + [ctypes.c_void_p])
    lib.mmad_instances.restype = ctypes.c_int
    lib.mmad_instances.argtypes = [ctypes.c_void_p, ctypes.c_int]
    built = compiled_instances(lib)
    if built != TC_INSTANCES:
        raise RuntimeError(f"csrc/mmad.cu compiled the tensor-core instances "
                           f"{built}, not {TC_INSTANCES}")
    return lib


def _library():
    global _lib
    if _lib is None:
        from repro_torch.kernels import build
        _lib = bind(build.load("mmad"))
    return _lib


def _num_sms(device: torch.device) -> int:
    idx = device.index if device.index is not None else torch.cuda.current_device()
    if idx not in _sm_count:
        _sm_count[idx] = torch.cuda.get_device_properties(idx).multi_processor_count
    return _sm_count[idx]


def b_layout(b: torch.Tensor) -> Optional[str]:
    """'rows' / 'cols' when B's rows / columns are contiguous and every
    16-byte vector the stream kernels load is aligned; None otherwise."""
    vec = 16 // b.element_size()
    k, n = b.shape
    if b.data_ptr() % 16:
        return None
    if b.stride(1) == 1 and b.stride(0) % vec == 0 and n % vec == 0:
        return "rows"
    if b.stride(0) == 1 and b.stride(1) % vec == 0 and k % vec == 0:
        return "cols"
    return None


def tma_describable(t: torch.Tensor, inner_dim: int) -> bool:
    """True when a TMA tensor map can describe 2-D `t` with dimension
    `inner_dim` as its contiguous one: a 16-byte aligned base, inner stride
    1, and the other stride a multiple of 16 bytes that does not overlap
    rows."""
    outer_dim = 1 - inner_dim
    return (t.data_ptr() % 16 == 0 and t.stride(inner_dim) == 1
            and t.stride(outer_dim) * t.element_size() % 16 == 0
            and t.stride(outer_dim) >= t.shape[inner_dim])


def wgmma_a_major(a: torch.Tensor) -> Optional[str]:
    """A's major as a tensor map reads it: 'k' (an activation, K-contiguous)
    or 'm' (the backward's `a.T`, M-contiguous); None when neither."""
    if tma_describable(a, 1):
        return "k"
    if tma_describable(a, 0):
        return "m"
    return None


def wgmma_b_major(a: torch.Tensor, b: torch.Tensor) -> Optional[str]:
    """B's major, 'n' (a (K, N) weight, or the gradient g) or 'k'
    (`embed.T`, or a weight's `b.T`), when A and B can feed a tensor-core
    variant; None when they cannot: unless both are bf16 or both fp16 (the
    `wgmma` variant) or both fp8 e4m3 with more than `STREAM_MAX_M` rows
    (the fp8 variant; fewer rows are the stream kernels'), each is
    contiguous along one dimension as `tma_describable` says, the (A, B)
    majors are an instance the kernel has (`WGMMA_MAJORS`; `FP8_MAJORS`,
    A K-contiguous), and the grids fit."""
    fp8 = a.dtype in FP8_DTYPES
    if a.dtype != b.dtype or not (fp8 or a.dtype in WGMMA_DTYPES):
        return None
    m, k = a.shape
    n = b.shape[1]
    bn = FP8_BN_FLAT if fp8 else WGMMA_BN     # the narrowest tile it takes
    if min(m, n, k) < 1 or math.ceil(n / bn) > WGMMA_MAX_N_TILES:
        return None
    if max(m, n, k) >= 2 ** 31 or (fp8 and m <= STREAM_MAX_M):
        return None
    b_major = ("n" if tma_describable(b, 1)
               else "k" if tma_describable(b, 0) else None)
    if (wgmma_a_major(a), b_major) not in (FP8_MAJORS if fp8
                                           else WGMMA_MAJORS):
        return None
    if fp8 and b_major == "n" and math.ceil(k / FP8_T_K) > FP8_MAX_T_K_TILES:
        return None
    return b_major


class WgmmaGeometry(NamedTuple):
    """What one tensor-core launch runs: its instance, its CTA grid (x: M
    tiles, y: N tiles), the K steps each CTA walks, and the ring and its
    dynamic shared memory."""
    grid: Tuple[int, int]
    k_steps: int
    stages: int
    stage_bytes: int
    smem_bytes: int
    instance: TensorCoreInstance = WGMMA_INSTANCE


def wgmma_geometry(m: int, n: int, k: int,
                   instance: Optional[TensorCoreInstance] = None
                   ) -> WgmmaGeometry:
    """Grid and ring of the tensor-core variant at `instance` (a 16-bit
    row of `TC_INSTANCES`; None: the route's own, `WGMMA_INSTANCE`), as
    csrc/mmad.cu lays it out. Pure Python, so the CPU tests pin it.

    One CTA per bm x bn output tile, walking all of K in bk-deep steps
    through a ring of the instance's stages. K is not split: on an H100
    the fp32 partials of a split cost more than the idle SMs gave back at
    every split count tried (csrc/mmad.cu)."""
    inst = instance or WGMMA_INSTANCE
    return WgmmaGeometry(
        (math.ceil(m / inst.bm), math.ceil(n / inst.bn)),
        math.ceil(k / inst.bk), inst.stages,
        (inst.bm * inst.bk + inst.bk * inst.bn) * 2, ring_bytes(inst), inst)


class Fp8Geometry(NamedTuple):
    """What one fp8 tensor-core call runs: its tile's N width, its CTA
    grid (x: M tiles, y: N tiles, z: K splits), k per split, the K steps a
    CTA walks, the ring and its dynamic shared memory, the transpose
    kernel's grid (None for a K-major B), and the scratch: one arrival
    counter per output tile when K is split, and a workspace of
    `ws_floats` fp32 holding the splits' partial tiles and, from float
    `bt_offset` on, the K-major copy of an N-major B (rows of `bt_row`
    bytes)."""
    bn: int
    grid: Tuple[int, int, int]
    kps: int
    splits: int
    k_steps: int
    stages: int
    stage_bytes: int
    smem_bytes: int
    transpose_grid: Optional[Tuple[int, int]]
    counters: int
    bt_offset: int
    bt_row: int
    ws_floats: int
    instance: Optional[TensorCoreInstance] = None

    @property
    def ctas(self) -> int:
        return self.grid[0] * self.grid[1] * self.grid[2]


def fp8_instance(bn: int) -> TensorCoreInstance:
    """The e4m3 instance of tile width `bn`."""
    return next(i for i in TC_INSTANCES if i.family == "e4m3" and i.bn == bn)


def fp8_tile_width(m: int, n: int, n_sms: int) -> int:
    """The fp8 variant's tile width: `FP8_BN_FLAT` for one M tile (M <=
    FP8_BM: its K split keeps the partial tiles small); for more, the
    width whose CTAs finish the tiles soonest, their waves on `n_sms` SMs
    times the columns a CTA works through over its rate (`FP8_BN_RATE`):
    M = 4096 x N = 2112 takes 352 128 x 192 tiles in 3 waves, not 544 in
    5; 2048 x 2048 keeps 256 128 x 128 tiles in 2 waves."""
    if m <= FP8_BM:
        return FP8_BN_FLAT
    tiles_m = math.ceil(m / FP8_BM)
    return min((FP8_BN_FLAT, FP8_BN), key=lambda bn: math.ceil(
        tiles_m * math.ceil(n / bn) / n_sms) * bn / FP8_BN_RATE[bn])


@functools.lru_cache(maxsize=1024)
def fp8_geometry(m: int, n: int, k: int, b_major: str, n_sms: int,
                 instance: Optional[TensorCoreInstance] = None
                 ) -> Fp8Geometry:
    """Grid, split and scratch of the fp8 tensor-core variant at
    `instance` (an e4m3 row of `TC_INSTANCES`; None: the route's own, its
    width as `fp8_tile_width` picks it), as csrc/mmad.cu lays them out.
    Pure Python, so the CPU tests pin it.

    One CTA per `FP8_BM` x bn output tile walks its K range in
    `FP8_BK`-deep steps through a ring of the instance's stages. K splits
    only where the tiles leave
    SMs idle (the flat GEMMs: M of 64 or 128 is one M tile), into as many
    splits as one wave of one CTA an SM holds, each a whole number of K
    steps; the last split to arrive at a tile sums the partials in split
    order in the same launch. Many tiles never split: their partials would
    cost more bytes than the idle SMs give back."""
    if b_major not in ("n", "k"):
        raise ValueError(f"no fp8 tensor-core instance for B major "
                         f"{b_major!r}")
    inst = instance or fp8_instance(fp8_tile_width(m, n, n_sms))
    bn = inst.bn
    tiles_m, tiles_n = math.ceil(m / FP8_BM), math.ceil(n / bn)
    tiles = tiles_m * tiles_n
    steps = math.ceil(k / FP8_BK)
    kps, splits = k, 1
    if tiles < n_sms and steps > 1:
        want = min(steps, n_sms // tiles)
        kps = math.ceil(steps / want) * FP8_BK
        splits = math.ceil(k / kps)
        if splits == 1:
            kps = k
    part = tiles * splits * FP8_BM * bn if splits > 1 else 0
    bt_offset = math.ceil(part / 64) * 64
    bt_row = math.ceil(k / 16) * 16
    transpose = (math.ceil(n / FP8_T_N), math.ceil(k / FP8_T_K))
    nmajor = b_major == "n"
    ws = bt_offset + math.ceil(n * bt_row / 4) if nmajor else part
    return Fp8Geometry(
        bn, (tiles_m, tiles_n, splits), kps, splits,
        math.ceil(kps / FP8_BK), inst.stages, (FP8_BM + bn) * FP8_BK,
        ring_bytes(inst), transpose if nmajor else None,
        tiles if splits > 1 else 0, bt_offset if nmajor else 0,
        bt_row if nmajor else 0, ws, inst)


class StreamGeometry(NamedTuple):
    """What one stream launch runs: its CTA grid (x: the row stream's
    column tiles or the column stream's item walkers; y: groups of
    `STREAM_ROWS` rows of A; z: K splits), k per split, the dynamic shared
    memory and the weight bytes a CTA keeps requested, and the scratch a
    split launch needs."""
    variant: int
    kps: int
    splits: int
    grid: Tuple[int, int, int]
    smem_bytes: int
    inflight_bytes: int  # per CTA: register batches or rings
    ctas_per_sm: int     # resident at most
    counters: int        # output tiles, when K is split
    ws_floats: int       # fp32 partials, when K is split

    @property
    def ctas(self) -> int:
        return self.grid[0] * self.grid[1] * self.grid[2]

    def inflight_bytes_per_sm(self, n_sms: int) -> int:
        """Weight bytes requested at once on a busy SM: as many CTAs as the
        grid puts there, at most `ctas_per_sm`."""
        per_sm = min(self.ctas_per_sm, math.ceil(self.ctas / n_sms))
        return per_sm * self.inflight_bytes


def _fewest_splits(tiles: int, k: int, unit: int, cap: int,
                   n_sms: int) -> Tuple[int, int]:
    """(k per split, splits): the fewest splits, each a whole number of
    `unit`s of at most `cap` k, that give `tiles * splits >= n_sms`; as
    many as there are units when even that is short."""
    n_units = math.ceil(k / unit)
    want = max(math.ceil(k / cap), math.ceil(n_sms / tiles))
    for s in range(min(want, n_units), n_units):
        kps = math.ceil(n_units / s) * unit
        splits = math.ceil(k / kps)
        if tiles * splits >= n_sms and kps <= cap:
            return kps, splits
    return unit, n_units


@functools.lru_cache(maxsize=1024)
def stream_geometry(m: int, n: int, k: int, layout: str, elem_bytes: int,
                    n_sms: int) -> StreamGeometry:
    """Grid, split and buffers of the stream kernel for a vector-loadable B
    (`layout` 'rows' or 'cols', as `b_layout` says), as csrc/mmad.cu
    lays it out. Pure Python, so the CPU tests pin it.

    Row stream: a CTA is a tile of `ROW_VECS` column vectors; K splits, in
    whole `ROW_UNIT`s of at most `ROW_MAX_KPS` k, only until the tiles fill
    `n_sms`. Column stream: an item is `STREAM_COLS` columns over a split's
    K range, K splits only until the items fill `n_sms`, and a grid of one
    CTA per SM walks the items, each consumer warp with a ring of its own.
    """
    vec = 16 // elem_bytes
    m_groups = math.ceil(m / STREAM_ROWS)
    if layout == "rows":
        tiles = math.ceil(n / (ROW_VECS * vec))
        kps, splits = _fewest_splits(m_groups * tiles, k, ROW_UNIT,
                                     ROW_MAX_KPS, n_sms)
        warp_sums = STREAM_WARPS * STREAM_ROWS * ROW_VECS * vec * 4
        return StreamGeometry(
            ROW_STREAM, kps, splits, (tiles, m_groups, splits),
            16 * kps + warp_sums, ROW_THREADS * ROW_BATCH * 16,
            1 if elem_bytes == 1 else 2,
            m_groups * tiles if splits > 1 else 0,
            splits * m * n if splits > 1 else 0)
    if layout != "cols":
        raise ValueError(f"no stream kernel for B layout {layout!r}")
    groups = math.ceil(n / STREAM_COLS)
    kps, splits = _fewest_splits(m_groups * groups, k, vec, COL_MAX_KPS,
                                 n_sms)
    rings = STREAM_WARPS * COL_STAGES * COL_STAGE_BYTES
    return StreamGeometry(
        COL_STREAM, kps, splits,
        (min(groups, COL_CTAS_PER_SM * n_sms), m_groups, splits),
        16 * kps + rings + STREAM_WARPS * COL_STAGES * 2 * 8, rings,
        COL_CTAS_PER_SM, m_groups * groups if splits > 1 else 0,
        splits * m * n if splits > 1 else 0)


class TileConfig(NamedTuple):
    """One instance of the SIMT tile kernel (csrc/mmad.cu TILE_CFGS): the
    code the launcher takes, the CTA tile (bm x bn), each thread's register
    block (tm x tn), the K slices a CTA's threads form, the ring's stages,
    and the CTAs an SM runs at once (`__launch_bounds__`' minimum, and the
    slots `_balanced_splits` fills)."""
    code: int
    bm: int
    bn: int
    tm: int
    tn: int
    k_slices: int
    stages: int
    min_ctas: int


TILE_CONFIGS = {
    "generic": TileConfig(0, 64, 64, 4, 4, 1, 2, 2),
    "narrow8": TileConfig(1, 64, 8, 1, 8, 4, 4, 2),
    "narrow16": TileConfig(2, 64, 16, 2, 8, 4, 4, 2),
    "narrow32": TileConfig(3, 64, 32, 4, 8, 4, 4, 2),
    "narrow64": TileConfig(4, 64, 64, 8, 8, 4, 4, 1),
    "wide": TileConfig(5, 128, 128, 8, 8, 1, 3, 1),
}
TILE_NARROW_MAX_N = 64
SPLIT_SLACK = 0.1        # _balanced_splits: the imbalance a split may leave


def tile_vectors(a: torch.Tensor, b: torch.Tensor) -> bool:
    """Whether the SIMT tile route's vector instances can read A and B:
    one dtype on both sides, A's rows K-contiguous and B's N-contiguous,
    and both bases and row strides 16-byte aligned, so every stage is
    copied in 16-byte `cp.async` chunks. Otherwise the generic instance
    (scalar loads, runtime dtypes, any strides) runs."""
    if a.dtype != b.dtype:
        return False
    size = a.element_size()
    return (a.stride(1) == 1 and b.stride(1) == 1
            and a.data_ptr() % 16 == 0 and b.data_ptr() % 16 == 0
            and a.stride(0) * size % 16 == 0
            and b.stride(0) * size % 16 == 0)


class TileGeometry(NamedTuple):
    """What one SIMT tile launch runs: the instance, its CTA grid (x: N
    tiles, y: M tiles, z: K splits), k per split, the dynamic shared
    memory, and the scratch a split launch needs (one arrival counter and
    `splits` fp32 partial tiles per output tile)."""
    instance: str
    code: int
    grid: Tuple[int, int, int]
    kps: int
    splits: int
    smem_bytes: int
    counters: int
    ws_floats: int

    @property
    def ctas(self) -> int:
        return self.grid[0] * self.grid[1] * self.grid[2]


def _balanced_splits(tiles: int, k: int, unit: int, n_sms: int,
                     per_sm: int) -> Tuple[int, int]:
    """(k per split, splits) for `tiles` output tiles on `n_sms` SMs that
    each run `per_sm` CTAs at once: each split a whole number of `unit`s,
    and the fewest splits whose busiest SM, `ceil(CTAs / (n_sms *
    per_sm))` waves of `kps` k, has at most `SPLIT_SLACK` more to do than
    an even share of the work (or than the best split, where none comes
    that close). More splits cost fp32 partials and a longer fix-up, and
    a CTA past the SMs' slots a second wave, so a split that balances the
    SMs only slightly better is not taken."""
    n_units = math.ceil(k / unit)
    slots = n_sms * per_sm
    options = []                    # (load, kps, splits), splits ascending
    for want in range(1, n_units + 1):
        kps = math.ceil(n_units / want) * unit    # the evenest cut
        splits = math.ceil(k / kps)
        if not options or splits > options[-1][2]:
            options.append((math.ceil(tiles * splits / slots) * kps, kps,
                            splits))
    target = max(tiles * k / slots, min(load for load, _, _ in options))
    return next((kps, splits) for load, kps, splits in options
                if load <= (1 + SPLIT_SLACK) * target)


def tile_instance(n: int, b_bytes: int, vector: bool) -> str:
    """The SIMT tile instance for N columns: narrow (N <= 64, a tile as wide
    as N rounded up to a power of two, at least one 16-byte chunk of B) or
    wide, when the operands allow vector loads; else generic."""
    if not vector:
        return "generic"
    if n > TILE_NARROW_MAX_N:
        return "wide"
    bn = 8
    while bn < max(n, 16 // b_bytes):
        bn *= 2
    return f"narrow{bn}"


@functools.lru_cache(maxsize=1024)
def tile_geometry(m: int, n: int, k: int, a_bytes: int, b_bytes: int,
                  n_sms: int, vector: bool = True) -> TileGeometry:
    """Instance, grid, split and buffers of the SIMT tile kernel, as
    csrc/mmad.cu lays them out. Pure Python, so the CPU tests pin it.

    `vector`: `tile_vectors(a, b)`, which implies `a_bytes == b_bytes`.
    K splits in whole `TILE_BK` stages, from the shape and the SM count
    alone (`_balanced_splits`); the plan's block geometry plays no part."""
    if vector and a_bytes != b_bytes:
        raise ValueError("the tile route's vector instances take one dtype")
    name = tile_instance(n, b_bytes, vector)
    cfg = TILE_CONFIGS[name]
    sa, sb = (a_bytes, b_bytes) if vector else (4, 4)   # generic stages fp32
    tiles_m, tiles_n = math.ceil(m / cfg.bm), math.ceil(n / cfg.bn)
    tiles = tiles_m * tiles_n
    kps, splits = _balanced_splits(tiles, k, TILE_BK, n_sms, cfg.min_ctas)
    if splits == 1:
        kps = k
    stage = cfg.bm * (TILE_BK * sa + 16) + TILE_BK * cfg.bn * sb
    red = cfg.k_slices * cfg.bm * (cfg.bn + 4) * 4
    split = splits > 1
    return TileGeometry(
        name, cfg.code, (tiles_n, tiles_m, splits), kps, splits,
        max(cfg.stages * stage, red), tiles if split else 0,
        tiles * splits * cfg.bm * cfg.bn if split else 0)


class Launch(tuple):
    """(variant, k per split, splits) of one launch, with the tensor-core
    instance it runs as `.instance` (None off the tensor cores)."""

    def __new__(cls, variant: int, kps: int, splits: int,
                instance: Optional[TensorCoreInstance] = None):
        launch = super().__new__(cls, (variant, kps, splits))
        launch.instance = instance
        return launch


def instance_for(elem_bytes: int,
                         block_shape: Tuple[int, int, int],
                         stages: Optional[int] = None) -> TensorCoreInstance:
    """The compiled instance of the operands' family (e4m3 for 1-byte,
    16-bit for 2-byte elements) at `block_shape` (bm, bn, bk) and `stages`
    (None: the one instance of that block). Raises `ValueError` naming the
    geometry when `TC_INSTANCES` has none."""
    family = "e4m3" if elem_bytes == 1 else "16bit"
    bm, bn, bk = _check_block(block_shape)
    found = [i for i in TC_INSTANCES if i.family == family
             and (i.bm, i.bn, i.bk) == (bm, bn, bk)
             and stages in (None, i.stages)]
    if len(found) != 1:
        raise ValueError(
            f"no {family} tensor-core instance at {bm} x {bn} x {bk}"
            + ("" if stages is None else f" with {stages} stages")
            + f"; csrc/mmad.cu compiles "
            + ", ".join(f"{i.bm}x{i.bn}x{i.bk}/{i.stages}"
                        for i in TC_INSTANCES if i.family == family))
    return found[0]


def plan_launch(m: int, n: int, k: int,
                block_shape: Optional[Tuple[int, int, int]],
                n_sms: int, layout: Optional[str] = None,
                elem_bytes: int = 2,
                wgmma_b: Optional[str] = None,
                tile_vector: bool = False,
                stages: Optional[int] = None) -> Launch:
    """(variant, k per split, splits) for one launch, its tensor-core
    instance as `.instance`.

    Up to `STREAM_MAX_M` rows with a vector-loadable B (`layout`), a stream
    kernel runs, laid out by `stream_geometry`. Otherwise, when the
    operands can feed the tensor cores (`wgmma_b`: B's major as
    `wgmma_b_major` gives it, for a K- or M-contiguous A), a tensor-core
    variant runs: for 1-byte operands (fp8 e4m3) the fp8 one, laid out by
    `fp8_geometry`, else the bf16 / fp16 one, laid out by
    `wgmma_geometry`, K unsplit; at the instance `block_shape` and
    `stages` name (`instance_for`), or with no `block_shape` at
    the route's own. Otherwise (and by default) the SIMT tile kernel runs,
    laid out by `tile_geometry`: a vector instance when `tile_vector`
    (`tile_vectors(a, b)`; the operands' one element size is
    `elem_bytes`), else the generic one. A `block_shape` for operands the
    tensor cores do not take raises `ValueError`: those routes have no
    geometry to give them."""
    stream = m <= STREAM_MAX_M and layout in ("rows", "cols")
    if block_shape is not None and (stream or wgmma_b is None):
        route = "a stream kernel" if stream else "the SIMT tile route"
        raise ValueError(f"({m}, {n}, {k}) takes {route}, which runs no "
                         f"plan geometry; given {tuple(block_shape)}")
    if stream:
        geo = stream_geometry(m, n, k, layout, elem_bytes, n_sms)
        return Launch(geo.variant, geo.kps, geo.splits)
    inst = (None if block_shape is None
            else instance_for(elem_bytes, block_shape, stages))
    if inst is not None and math.ceil(n / inst.bn) > WGMMA_MAX_N_TILES:
        raise ValueError(f"N = {n} takes more than {WGMMA_MAX_N_TILES} "
                         f"tiles of {inst.bn} columns")
    if wgmma_b is not None and elem_bytes == 1:
        geo = fp8_geometry(m, n, k, wgmma_b, n_sms, inst)
        return Launch(WGMMA_FP8, geo.kps, geo.splits, geo.instance)
    if wgmma_b is not None:
        return Launch(WGMMA, k, 1, inst or WGMMA_INSTANCE)
    geo = tile_geometry(m, n, k, elem_bytes, elem_bytes, n_sms, tile_vector)
    return Launch(TILE, geo.kps, geo.splits)


def takes_tensor_cores(a: torch.Tensor, b: torch.Tensor) -> bool:
    """Whether `mmad` launches a @ b on a tensor-core variant: as
    `plan_launch` routes, not a stream kernel's few rows, and operands
    `wgmma_b_major` admits."""
    if a.shape[0] <= STREAM_MAX_M and b_layout(b) is not None:
        return False
    return wgmma_b_major(a, b) is not None


def _check_block(block_shape) -> Tuple[int, int, int]:
    bs = tuple(int(x) for x in block_shape)
    if len(bs) != 3 or min(bs) < 1:
        raise ValueError(f"block shape must be three positive ints, got "
                         f"{block_shape}")
    return bs


def mmad(a: torch.Tensor, b: torch.Tensor,
         block_shape: Optional[Tuple[int, int, int]] = None,
         out_dtype: Optional[torch.dtype] = None,
         stages: Optional[int] = None) -> torch.Tensor:
    """C = A @ B with a float32 accumulator, A (M, K), B (K, N), any strides.

    `block_shape` (bm, bn, bk) and `stages` name the tensor-core instance
    a CUDA launch runs (`plan_launch`; None: the route's own geometry).
    Unlike the Pallas kernel, shapes need not divide the block shape: the
    kernel masks the ragged edge itself. CPU operands run the plain
    version, whatever block they are given; meta operands (the dry run's
    shape-only trace) give an empty meta tensor of the product's shape and
    launch nothing. The whole call, checks and plain version included, is
    named `mmad.launch` for the profiler."""
    with profile_scope("mmad.launch"):
        if a.dim() != 2 or b.dim() != 2:
            raise ValueError(f"mmad takes 2-D operands, got "
                             f"{tuple(a.shape)} @ {tuple(b.shape)}")
        m, k = a.shape
        k2, n = b.shape
        if k != k2:
            raise ValueError(f"inner dims mismatch: {tuple(a.shape)} @ "
                             f"{tuple(b.shape)}")
        bs = None if block_shape is None else _check_block(block_shape)
        out_dtype = out_dtype or a.dtype
        if a.device.type == "cpu" and b.device.type == "cpu":
            return ref.mmad_ref(a, b, out_dtype)
        if a.device.type == "meta" and b.device.type == "meta":
            return torch.empty((m, n), dtype=out_dtype, device=a.device)
        if a.device.type != "cuda" or b.device != a.device:
            raise ValueError(f"mmad operands must both be on one CUDA "
                             f"device or both on the CPU, got {a.device} "
                             f"and {b.device}")
        for name, t in (("A", a), ("B", b)):
            if t.dtype not in DTYPE_CODES:
                raise TypeError(f"mmad kernel does not take {name} dtype "
                                f"{t.dtype}; have "
                                f"{sorted(map(str, DTYPE_CODES))}")
        if out_dtype not in OUT_DTYPES:
            raise TypeError(f"mmad kernel writes {OUT_DTYPES}, not "
                            f"{out_dtype}")
        return _launch(a, b, bs, stages, out_dtype)


def counter_buffer(device: torch.device, stream: int,
                   size: int = 0) -> torch.Tensor:
    """The split-K arrival counters of launches on `stream`, at least `size`
    long: zeros from `torch.zeros`, grown when a launch needs more, and left
    at zero by every launch (the last split to arrive resets its tile's)."""
    key = (device.index, stream)
    buf = _counters.get(key)
    if buf is None or buf.numel() < size:
        buf = torch.zeros(max(size, 1024), dtype=torch.int32, device=device)
        _counters[key] = buf
    return buf


def workspace(device: torch.device, stream: int, size: int) -> torch.Tensor:
    """The fp32 split-K partials of launches on `stream`, at least `size`
    long, grown when a launch needs more. Launches on one stream run in
    order, so each may overwrite the last one's partials."""
    key = (device.index, stream)
    buf = _workspaces.get(key)
    if buf is None or buf.numel() < size:
        buf = torch.empty(size, dtype=torch.float32, device=device)
        _workspaces[key] = buf
    return buf


def _launch(a: torch.Tensor, b: torch.Tensor, block_shape, stages,
            out_dtype):
    """Launch on the current stream."""
    global _launches
    m, k = a.shape
    n = b.shape[1]
    out = torch.empty((m, n), dtype=out_dtype, device=a.device)
    if m == 0 or n == 0:
        return out
    n_sms = _num_sms(a.device)
    layout = b_layout(b)
    vector = tile_vectors(a, b)
    wgmma_b = wgmma_b_major(a, b)
    launch = plan_launch(m, n, max(k, 1), block_shape, n_sms, layout,
                         b.element_size(), wgmma_b, vector, stages)
    variant, kps, splits = launch
    # the stream kernels' grid x, the tile instance, the tensor-core
    # instance's index, or the fp8 one's index x 256 + its K steps between
    # promotions
    sub = 0
    stream = torch.cuda.current_stream(a.device).cuda_stream
    counters = ws = None
    if variant in (ROW_STREAM, COL_STREAM):
        geo = stream_geometry(m, n, max(k, 1), layout, b.element_size(), n_sms)
        sub = geo.grid[0]
    elif variant == TILE:
        geo = tile_geometry(m, n, max(k, 1), a.element_size(),
                            b.element_size(), n_sms, vector)
        sub = geo.code
    elif variant == WGMMA:
        sub = TC_INSTANCES.index(launch.instance)
    elif variant == WGMMA_FP8:
        geo = fp8_geometry(m, n, k, wgmma_b, n_sms, launch.instance)
        sub = TC_INSTANCES.index(launch.instance) * 256 + FP8_PROMOTE_STEPS
        if geo.ws_floats:
            # partials and B's K-major copy: one call's scratch, from the
            # stream-ordered caching allocator
            ws = torch.empty(geo.ws_floats, dtype=torch.float32,
                             device=a.device)
    if splits > 1:
        counters = counter_buffer(a.device, stream, geo.counters)
        if ws is None:
            ws = workspace(a.device, stream, geo.ws_floats)
    err = _library().mmad_launch(
        a.data_ptr(), b.data_ptr(), out.data_ptr(),
        ws.data_ptr() if ws is not None else None,
        counters.data_ptr() if counters is not None else None,
        DTYPE_CODES[a.dtype], DTYPE_CODES[b.dtype], DTYPE_CODES[out_dtype],
        m, n, k, a.stride(0), a.stride(1), b.stride(0), b.stride(1),
        kps, splits, variant, sub, stream)
    if err != 0:
        raise RuntimeError(f"mmad launch failed: cudaError {err} "
                           f"(M={m} N={n} K={k} variant={variant} "
                           f"sub={sub} splits={splits})")
    _launches += 1
    key = (variant, (m, n, k), launch.instance, block_shape is not None)
    _geometries[key] = _geometries.get(key, 0) + 1
    return out
