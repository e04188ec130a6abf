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
is two transposed fp32 matmuls, and it never *narrows* operands: casting to
the kernel's dtype happens only when that dtype is at least as wide as the
data — quantizing to fp8/int8 is the model's decision, not the scheduler's.

Dispatch follows the tensors' device: CUDA tensors run the kernel (or the
wrapper raises), CPU tensors run the plain version. There is no fallback
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


def _local_matmul_impl(a: torch.Tensor, b: torch.Tensor,
                       kernel: InnerKernel) -> torch.Tensor:
    a = _cast_operand(a, kernel)
    b = _cast_operand(b, kernel)
    return tile_matmul(a, b, block_shape=kernel.geometry(),
                       out_dtype=torch.float32)


class _LocalMatmul(torch.autograd.Function):
    @staticmethod
    def forward(ctx, a, b, kernel):
        ctx.save_for_backward(a, b)
        return _local_matmul_impl(a, b, kernel)

    @staticmethod
    def backward(ctx, g):
        # plain products outside any kernel, as in the reference
        a, b = ctx.saved_tensors
        g32 = g.float()
        da = torch.matmul(g32, b.float().T).to(a.dtype)
        db = torch.matmul(a.float().T, g32).to(b.dtype)
        return da, db, None


def local_matmul(a: torch.Tensor, b: torch.Tensor,
                 kernel: InnerKernel) -> torch.Tensor:
    """Per-device C = A @ B under a planner-resolved inner kernel, fp32 out.

    CUDA tensors run the `mmad` kernel, given the kernel's block geometry
    (which its decode-path variants do not read; see `kernels/mmad.py`); CPU
    tensors run the plain fp32 product (the reference's CPU expression).
    Reverse-differentiable (transposed fp32 matmuls), so routed training
    works through the kernel path too; with no gradient to record (serving
    under `inference_mode`) the autograd node is skipped."""
    if torch.is_grad_enabled() and (a.requires_grad or b.requires_grad):
        return _LocalMatmul.apply(a, b, kernel)
    return _local_matmul_impl(a, b, kernel)
