"""The per-tile MMAD (paper Fig. 3b) as a hand-written Hopper CUDA kernel.

Replaces `repro/kernels/mmad.py:_mmad_kernel`, the Pallas TPU kernel that
streams (bm x bk) / (bk x bn) blocks HBM->VMEM over an (M/bm, N/bn, K/bk)
grid and keeps an fp32 accumulator across the sequential K axis. The CUDA
source is `csrc/mmad.cu`; its header note says how the TPU design was
rethought for the card.

What bounds it on an H100: on the routed decode path (M = batch = 4) every
GEMM reads its (K, N) weight once and does 8 FLOPs per weight element, so
it is bound by device-memory bytes (3.35 TB/s), not by the tensor cores.
What the design does about it: for up to 16 rows of A with a weight whose
rows (or columns) are contiguous and 16-byte aligned — every decode GEMM —
a stream kernel reads the weight once with 16-byte vector loads, coalesced
along its contiguous dim, and never stages it: the row stream for (K, N)
weights, the column stream for the tied lm_head weight `embed.T`, a
strided view the kernel reads in place (a pad or `.contiguous()` would copy
1 GB per step). K splits over extra CTAs until the grid holds about two
CTAs per SM. Everything else — more rows, unaligned or arbitrarily strided
operands — takes the tile kernel, which stages 64 x 64 fp32 tiles in shared
memory.

The plan's (bm, bn, bk) block geometry is accepted, power of two or not,
but it does not shape what runs on the card. The stream kernels ignore it
entirely, so on the decode path the planner's `InnerKernel` choice has no
effect; the tile kernel reads only `bk`, as its split-K granularity (each
CTA's K range is a whole number of bk blocks). The CTA shapes are the
kernel's own: register accumulators need compile-time shapes, and the fp32
contract does not depend on the tiling. Honouring the geometry, or pricing
this card without the inner-kernel term, is queued in ROADMAP.md.

Dispatch is by the tensors' device and nothing else: CUDA tensors launch the
kernel or raise; CPU tensors (which only a caller that chose the CPU holds)
take the plain version in `kernels/ref.py`. `launch_count()` counts kernel
launches, so a run can show that its GEMMs went through the kernel.
"""
from __future__ import annotations

import ctypes
import math
from typing import Optional, Tuple

import torch

from repro_torch.kernels import ref

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
TILE, ROW_STREAM, COL_STREAM = 0, 1, 2
TILE_EDGE = 64           # the tile variant's 64 x 64 output tile
STREAM_MAX_M = 16        # the stream variants take up to this many rows
STREAM_ROWS = 4          # rows of A per stream CTA (SK_MT)
STREAM_WARPS = 8         # warps per stream CTA (SK_WARPS)
STREAM_COLS = 8          # columns per warp of the column stream (SK_COLS)
ROW_STREAM_CHUNK = 128   # a row-stream split covers whole 128-row chunks

_launches = 0
_lib = None
_sm_count = {}


def launch_count() -> int:
    """Kernel launches since the last `reset_launch_count()`."""
    return _launches


def reset_launch_count() -> None:
    global _launches
    _launches = 0


def _library():
    global _lib
    if _lib is None:
        from repro_torch.kernels import build
        lib = build.load("mmad")
        fn = lib.mmad_launch
        fn.restype = ctypes.c_int
        fn.argtypes = ([ctypes.c_void_p] * 4 + [ctypes.c_int] * 3
                       + [ctypes.c_longlong] * 8
                       + [ctypes.c_int, ctypes.c_int, ctypes.c_void_p])
        _lib = lib
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


def plan_launch(m: int, n: int, k: int, block_shape: Tuple[int, int, int],
                n_sms: int, layout: Optional[str] = None,
                elem_bytes: int = 2) -> Tuple[int, int, int]:
    """(variant, k per split, splits) for one launch.

    Up to `STREAM_MAX_M` rows with a vector-loadable B (`layout`), the
    stream kernels run; K splits until the grid holds about two CTAs per SM
    (decode's N = 256..2048 alone would leave most SMs idle). Otherwise the
    tile kernel runs, with K split in whole plan-`bk` blocks. `bk` is the
    only part of the block shape that is read."""
    bk = block_shape[2]
    if m <= STREAM_MAX_M and layout in ("rows", "cols"):
        vec = 16 // elem_bytes
        if layout == "rows":
            variant, per_cta, unit = ROW_STREAM, 32 * vec, ROW_STREAM_CHUNK
        else:
            variant, per_cta, unit = COL_STREAM, STREAM_WARPS * STREAM_COLS, 32 * vec
        tiles = math.ceil(m / STREAM_ROWS) * math.ceil(n / per_cta)
        want = max(1, math.ceil(2 * n_sms / tiles))
        kps = max(unit, math.ceil(math.ceil(k / want) / unit) * unit)
        return variant, kps, max(1, math.ceil(k / kps))
    tiles = math.ceil(m / TILE_EDGE) * math.ceil(n / TILE_EDGE)
    n_kb = max(1, math.ceil(k / bk))
    want = max(1, math.ceil(2 * n_sms / tiles))
    per_split = math.ceil(n_kb / min(want, n_kb))
    splits = math.ceil(n_kb / per_split)
    return TILE, per_split * bk, splits


def _check_block(block_shape) -> Tuple[int, int, int]:
    bs = tuple(int(x) for x in block_shape)
    if len(bs) != 3 or min(bs) < 1:
        raise ValueError(f"block shape must be three positive ints, got "
                         f"{block_shape}")
    return bs


def mmad(a: torch.Tensor, b: torch.Tensor,
         block_shape: Tuple[int, int, int] = (128, 128, 128),
         out_dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """C = A @ B with a float32 accumulator, A (M, K), B (K, N), any strides.

    Unlike the Pallas kernel, shapes need not divide the block shape: the
    kernel masks the ragged edge itself."""
    if a.dim() != 2 or b.dim() != 2:
        raise ValueError(f"mmad takes 2-D operands, got {tuple(a.shape)} @ "
                         f"{tuple(b.shape)}")
    m, k = a.shape
    k2, n = b.shape
    if k != k2:
        raise ValueError(f"inner dims mismatch: {tuple(a.shape)} @ "
                         f"{tuple(b.shape)}")
    bs = _check_block(block_shape)
    out_dtype = out_dtype or a.dtype
    if a.device.type == "cpu" and b.device.type == "cpu":
        return ref.mmad_ref(a, b, out_dtype)
    if a.device.type != "cuda" or b.device != a.device:
        raise ValueError(f"mmad operands must both be on one CUDA device or "
                         f"both on the CPU, got {a.device} and {b.device}")
    for name, t in (("A", a), ("B", b)):
        if t.dtype not in DTYPE_CODES:
            raise TypeError(f"mmad kernel does not take {name} dtype {t.dtype}; "
                            f"have {sorted(map(str, DTYPE_CODES))}")
    if out_dtype not in OUT_DTYPES:
        raise TypeError(f"mmad kernel writes {OUT_DTYPES}, not {out_dtype}")
    return _launch(a, b, bs, out_dtype)


def _launch(a: torch.Tensor, b: torch.Tensor, block_shape, out_dtype):
    """Launch on the current stream."""
    global _launches
    m, k = a.shape
    n = b.shape[1]
    out = torch.empty((m, n), dtype=out_dtype, device=a.device)
    if m == 0 or n == 0:
        return out
    variant, kps, splits = plan_launch(m, n, max(k, 1), block_shape,
                                       _num_sms(a.device),
                                       b_layout(b),
                                       b.element_size())
    ws = (torch.empty((splits, m, n), dtype=torch.float32, device=a.device)
          if splits > 1 else None)
    lib = _library()
    cuda_stream = torch.cuda.current_stream(a.device).cuda_stream
    err = lib.mmad_launch(
        a.data_ptr(), b.data_ptr(), out.data_ptr(),
        ws.data_ptr() if ws is not None else None,
        DTYPE_CODES[a.dtype], DTYPE_CODES[b.dtype], DTYPE_CODES[out_dtype],
        m, n, k, a.stride(0), a.stride(1), b.stride(0), b.stride(1),
        kps, splits, variant, cuda_stream)
    if err != 0:
        raise RuntimeError(f"mmad launch failed: cudaError {err} "
                           f"(M={m} N={n} K={k} variant={variant} "
                           f"splits={splits})")
    _launches += 1
    return out
