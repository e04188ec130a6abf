"""Public wrappers around the `mmad` kernel.

`tile_matmul` is the block-shaped entry point: it dispatches to
`kernels.mmad.mmad` at the tensor-core instance the caller names, or with
none at the geometry `mmad`'s route picks (the reference picks a Pallas
block here, `pick_block_shape`; no CUDA launch reads one). The reference
pads A and B to block multiples because the Pallas kernel needs divisible
shapes; the CUDA kernel masks the ragged edge itself, so nothing is padded
or copied here and the result equals the reference's padded-then-sliced
one.

`local_matmul` is the schedule-resolved entry point: the mesh dataflows in
`core/gemm.py` call it with the lowered plan's `InnerKernel`, so the
planner's CTA tile, K step, ring depth and compute dtype reach the
per-device GEMM. It is
a `torch.autograd.Function` (the reference's `jax.custom_vjp`) whose backward
is the two transposed products, and it never *narrows* operands: casting to
the kernel's dtype happens only when that dtype is at least as wide as the
data — quantizing to fp8/int8 is the model's decision, not the scheduler's.

The backward's precision follows the reference on its chip. The
reference's `_local_matmul_bwd` is `jnp.dot` on fp32 operands at DEFAULT
precision, which a TPU runs as bfloat16 passes (and an H100 as TF32); only
its CPU run is IEEE fp32. So CUDA operands saved as bf16 or fp16 take
`backward_products`: g is rounded to the operand dtype (on a 1x1 mesh it
is the fp32 image of a bf16 gradient, since every mode body returns
`.to(a.dtype)`, so the rounding is exact) and both products run on
`mmad`'s tensor cores with fp32 sums. CPU tensors and fp32 operands keep
the fp32 products, which is what the CPU parity tests compare.

Dispatch follows the tensors' device: CUDA tensors run the kernel (or the
wrapper raises), CPU tensors run the plain version, and meta tensors (the
dry run's shape-only trace) give an fp32 meta tensor of the product's
shape, forward and backward, launching nothing. There is no fallback
from one to the other.
"""
from __future__ import annotations

from typing import Optional, Tuple

import torch

from repro_torch.core.ir import ELEM_BYTES_OF_DTYPE
from repro_torch.core.schedule import INNER_VMEM_BUDGET, InnerKernel
from repro_torch.kernels.mmad import mmad, takes_tensor_cores
from repro_torch.obs.trace import profile_scope

# working-set budget for picking block shapes (bytes), shared with the
# schedule level so `pick_block_shape` picks what the reference picks
_VMEM_BUDGET = INNER_VMEM_BUDGET

# schedule dtype names -> torch dtypes for the compute-dtype cast. fp8 is
# the OCP e4m3 variant (float8_e4m3fn), as in the reference; accumulation
# is fp32 regardless.
_TORCH_OF_DTYPE = {
    "float32": torch.float32,
    "bfloat16": torch.bfloat16,
    "float16": torch.float16,
    "float8_e4m3": torch.float8_e4m3fn,
    "int8": torch.int8,
}
_NAME_OF_DTYPE = {v: k for k, v in _TORCH_OF_DTYPE.items()}


def _round_up(x: int, mult: int) -> int:
    return (x + mult - 1) // mult * mult


def pick_block_shape(m: int, n: int, k: int, elem_bytes: int = 2
                     ) -> Tuple[int, int, int]:
    """Aligned block shape whose double-buffered working set fits the budget.

    Same rule as the reference: prefer (128, 128, bk) with the largest bk
    that divides the 128-padded K and fits (larger K chunks amortize the
    accumulator flush). The reference's `tile_matmul` runs its Pallas
    kernel at this block when given none; no CUDA launch reads it: with no
    block `mmad`'s route picks its own geometry."""
    bm = min(128, _round_up(m, 8))
    bn = min(128, _round_up(n, 128))
    kp = _round_up(k, 128)
    bk = 128
    while True:
        nxt = bk * 2
        ws = (bm * nxt + nxt * bn) * elem_bytes * 2 + bm * bn * 4
        if nxt <= kp and kp % nxt == 0 and ws <= _VMEM_BUDGET:
            bk = nxt
        else:
            break
    return bm, bn, min(bk, kp)


def tile_matmul(a: torch.Tensor, b: torch.Tensor,
                block_shape: Optional[Tuple[int, int, int]] = None,
                out_dtype: Optional[torch.dtype] = None,
                stages: Optional[int] = None) -> torch.Tensor:
    """C = A @ B through the MMAD kernel, at the tensor-core instance
    `block_shape` and `stages` name (None: the route's own geometry).

    Any M, N, K: the kernel masks what the reference pads."""
    return mmad(a, b, block_shape=block_shape, out_dtype=out_dtype,
                stages=stages)


# ---------------------------------------------------------------------------
# Schedule-resolved local matmul (the two-level tuning dispatch point)
# ---------------------------------------------------------------------------

def _cast_dtype(have: torch.dtype, kernel: InnerKernel) -> torch.dtype:
    """The kernel's compute dtype, UNLESS casting `have` to it would
    narrow the data: then `have`.

    The planner may pick an fp8 kernel for an fp8-native part; if the model
    actually feeds fp32 activations, quantization is its call to make — the
    dispatch must not silently destroy precision. Widening (bf16 data on an
    fp32 kernel) is always safe."""
    if not kernel.dtype:
        return have
    want = _TORCH_OF_DTYPE.get(kernel.dtype)
    if want is None:
        return have
    if ELEM_BYTES_OF_DTYPE[kernel.dtype] < have.itemsize:
        return have
    # never cross float/int kinds either (int8-kernel on fp8 data would
    # reinterpret values, not widen them)
    if have.is_floating_point != want.is_floating_point:
        return have
    return want


def _cast_operand(x: torch.Tensor, kernel: InnerKernel) -> torch.Tensor:
    """`x` in the dtype `_cast_dtype` gives it (itself when that is its
    own)."""
    return x.to(_cast_dtype(x.dtype, kernel))


def tensor_core_dtype(kernel: Optional[InnerKernel], a: torch.Tensor,
                      b: torch.Tensor) -> str:
    """The dtype name `local_matmul` launches a @ b in on a tensor-core
    variant under `kernel` (after `_cast_operand`), or "" when the product
    takes a stream kernel or the SIMT tile route. Lowering on a CUDA mesh
    demotes an inner kernel whose family this dtype is not. Nothing is
    cast: an operand the cast would change is judged by an empty meta
    tensor of its shape, its strides after the cast and the cast dtype
    (a fresh copy is aligned, as a meta tensor's null base reads)."""
    def as_cast(x):
        want = x.dtype if kernel is None else _cast_dtype(x.dtype, kernel)
        if want == x.dtype:
            return x
        return torch.empty_like(x, dtype=want, device="meta")
    a, b = as_cast(a), as_cast(b)
    if not takes_tensor_cores(a, b):
        return ""
    return _NAME_OF_DTYPE.get(a.dtype, "")


def block_for(kernel: Optional[InnerKernel]
              ) -> Tuple[Optional[Tuple[int, int, int]], Optional[int]]:
    """The (block, stages) `local_matmul` hands `mmad`: the inner kernel's
    geometry and its depth as the ring's stages, or (None, None) with no
    inner kernel, for the route to pick."""
    if kernel is None:
        return None, None
    return kernel.geometry(), kernel.depth


def _local_matmul_impl(a: torch.Tensor, b: torch.Tensor,
                       kernel: Optional[InnerKernel]) -> torch.Tensor:
    if kernel is not None:
        a = _cast_operand(a, kernel)
        b = _cast_operand(b, kernel)
    block, stages = block_for(kernel)
    return tile_matmul(a, b, block_shape=block, out_dtype=torch.float32,
                       stages=stages)


def tensor_core_backward(a: torch.Tensor, b: torch.Tensor) -> bool:
    """Whether `local_matmul`'s backward runs on `mmad`: CUDA operands saved
    as bf16 (or fp16) on both sides. Chosen by device and dtype alone; a
    launch the kernel refuses raises, as the forward's does."""
    return (a.is_cuda and b.is_cuda and a.dtype == b.dtype
            and a.dtype in (torch.bfloat16, torch.float16))


def padded_rows(g: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """`g` rounded to `dtype` (2-D), its rows laid out in whole 16 bytes:
    a view of g's shape into a buffer whose rows are padded, when g's
    width would not give a row stride a TMA tensor map can take (seamless's
    lm_head, N = 256,206). The rounding copies g anyway, so the padded
    copy costs no more."""
    m, n = g.shape
    per = 16 // dtype.itemsize
    if n % per == 0:
        return g.to(dtype)
    out = torch.empty((m, -(-n // per) * per), dtype=dtype,
                      device=g.device)[:, :n]
    out.copy_(g)
    return out


def cast_c(c: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """An fp32 product C in its operands' `dtype`: the one place a routed
    GEMM's C is cast (every mode body of `core/gemm.py` and
    `backward_products`), named `gemm.cast` for the profiler."""
    with profile_scope("gemm.cast"):
        return c.to(dtype)


def backward_products(g: torch.Tensor, a: torch.Tensor,
                      b: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """da = g @ b.T and db = a.T @ g on `mmad`, g rounded to the operand
    dtype, fp32 sums, each rounded once to its operand's dtype. The
    operands stay views: b.T is K-contiguous (lm_head's is `embed`,
    N-contiguous) and a.T M-contiguous, which the tensor-core variant reads
    in place; g's rows are padded to whole 16 bytes where its width needs
    it, so the tensor-core variant reads it too."""
    g = padded_rows(g, a.dtype)
    da = cast_c(mmad(g, b.T, out_dtype=torch.float32), a.dtype)
    db = cast_c(mmad(a.T, g, out_dtype=torch.float32), b.dtype)
    return da, db


class _LocalMatmul(torch.autograd.Function):
    @staticmethod
    def forward(ctx, a, b, kernel):
        ctx.save_for_backward(a, b)
        return _local_matmul_impl(a, b, kernel)

    @staticmethod
    def backward(ctx, g):
        a, b = ctx.saved_tensors
        if tensor_core_backward(a, b):
            return (*backward_products(g, a, b), None)
        g32 = g.float()
        da = cast_c(torch.matmul(g32, b.float().T), a.dtype)
        db = cast_c(torch.matmul(a.float().T, g32), b.dtype)
        return da, db, None


def local_matmul(a: torch.Tensor, b: torch.Tensor,
                 kernel: Optional[InnerKernel]) -> torch.Tensor:
    """Per-device C = A @ B under a planner-resolved inner kernel, fp32 out.

    CUDA tensors run the `mmad` kernel at the inner kernel's tensor-core
    instance (`block_for`), or with no inner kernel at the geometry its
    route picks, in the operands' own dtypes; CPU
    tensors run the plain fp32 product (the reference's CPU expression).
    Reverse-differentiable (`backward_products` on the card for bf16 and
    fp16 operands, fp32 matmuls otherwise), so routed training works
    through the kernel path too; with no gradient to record (serving under
    `inference_mode`) the autograd node is skipped."""
    if torch.is_grad_enabled() and (a.requires_grad or b.requires_grad):
        return _LocalMatmul.apply(a, b, kernel)
    return _local_matmul_impl(a, b, kernel)
