"""Public wrappers around the `mmad` kernel.

`tile_matmul` is the block-shaped entry point: it picks a block shape when
the caller gives none and dispatches to `kernels.mmad.mmad`. The reference
pads A and B to block multiples because the Pallas kernel needs divisible
shapes; the CUDA kernel masks the ragged edge itself, so nothing is padded
or copied here and the result equals the reference's padded-then-sliced one.

`local_matmul` is the schedule-resolved entry point: the mesh dataflows in
`core/gemm.py` call it with the lowered plan's `InnerKernel`, so the
planner's block geometry and compute dtype reach the per-device GEMM. It is
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
from repro_torch.kernels.mmad import mmad

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


def _round_up(x: int, mult: int) -> int:
    return (x + mult - 1) // mult * mult


def pick_block_shape(m: int, n: int, k: int, elem_bytes: int = 2
                     ) -> Tuple[int, int, int]:
    """Aligned block shape whose double-buffered working set fits the budget.

    Same rule as the reference: prefer (128, 128, bk) with the largest bk
    that divides the 128-padded K and fits (larger K chunks amortize the
    accumulator flush)."""
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
                out_dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """C = A @ B through the MMAD kernel at `block_shape` (picked when None).

    Any M, N, K: the kernel masks what the reference pads."""
    m, k = a.shape
    n = b.shape[1]
    bs = block_shape or pick_block_shape(m, n, k, a.element_size())
    return mmad(a, b, block_shape=bs, out_dtype=out_dtype)


# ---------------------------------------------------------------------------
# Schedule-resolved local matmul (the two-level tuning dispatch point)
# ---------------------------------------------------------------------------

def _cast_operand(x: torch.Tensor, kernel: InnerKernel) -> torch.Tensor:
    """Cast to the kernel's compute dtype UNLESS that would narrow the data.

    The planner may pick an fp8 kernel for an fp8-native part; if the model
    actually feeds fp32 activations, quantization is its call to make — the
    dispatch must not silently destroy precision. Widening (bf16 data on an
    fp32 kernel) is always safe."""
    if not kernel.dtype:
        return x
    want = _TORCH_OF_DTYPE.get(kernel.dtype)
    if want is None:
        return x
    if ELEM_BYTES_OF_DTYPE[kernel.dtype] < x.element_size():
        return x
    # never cross float/int kinds either (int8-kernel on fp8 data would
    # reinterpret values, not widen them)
    if x.dtype.is_floating_point != want.is_floating_point:
        return x
    return x.to(want)


def block_for(kernel: Optional[InnerKernel], m: int, n: int, k: int,
              elem_bytes: int) -> Tuple[int, int, int]:
    """The block `local_matmul` runs an (m, n, k) product at: the inner
    kernel's geometry, or with no inner kernel the one `pick_block_shape`
    picks for the operands' element size."""
    if kernel is None:
        return pick_block_shape(m, n, k, elem_bytes)
    return kernel.geometry()


def _local_matmul_impl(a: torch.Tensor, b: torch.Tensor,
                       kernel: Optional[InnerKernel]) -> torch.Tensor:
    if kernel is not None:
        a = _cast_operand(a, kernel)
        b = _cast_operand(b, kernel)
    bs = block_for(kernel, a.shape[0], b.shape[1], a.shape[1],
                   a.element_size())
    return tile_matmul(a, b, block_shape=bs, out_dtype=torch.float32)


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


def backward_products(g: torch.Tensor, a: torch.Tensor,
                      b: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """da = g @ b.T and db = a.T @ g on `mmad`, g rounded to the operand
    dtype, fp32 sums, each rounded once to its operand's dtype. The
    operands stay views: b.T is K-contiguous (lm_head's is `embed`,
    N-contiguous) and a.T M-contiguous, which the tensor-core variant reads
    in place; g's rows are padded to whole 16 bytes where its width needs
    it, so the tensor-core variant reads it too."""
    g = padded_rows(g, a.dtype)
    da = mmad(g, b.T, out_dtype=torch.float32).to(a.dtype)
    db = mmad(a.T, g, out_dtype=torch.float32).to(b.dtype)
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
        da = torch.matmul(g32, b.float().T).to(a.dtype)
        db = torch.matmul(a.float().T, g32).to(b.dtype)
        return da, db, None


def local_matmul(a: torch.Tensor, b: torch.Tensor,
                 kernel: Optional[InnerKernel]) -> torch.Tensor:
    """Per-device C = A @ B under a planner-resolved inner kernel, fp32 out.

    CUDA tensors run the `mmad` kernel, given the kernel's block geometry
    (which its decode-path variants do not read; see `kernels/mmad.py`), or
    with no inner kernel the block `block_for` picks, in the operands' own
    dtypes; CPU
    tensors run the plain fp32 product (the reference's CPU expression).
    Reverse-differentiable (`backward_products` on the card for bf16 and
    fp16 operands, fp32 matmuls otherwise), so routed training works
    through the kernel path too; with no gradient to record (serving under
    `inference_mode`) the autograd node is skipped."""
    if torch.is_grad_enabled() and (a.requires_grad or b.requires_grad):
        return _LocalMatmul.apply(a, b, kernel)
    return _local_matmul_impl(a, b, kernel)
