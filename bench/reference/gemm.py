"""Plain reference of a deployed GEMM: the exact product of the operands a
cell hands the program, and the control computed below the cell's
precision.

The operands are e4m3 or bf16 values, exact in float64, so the float64
product (blocks of rows at a time) is exact to within float64's rounding,
far below any reading here. Nothing here imports the program.
"""
from __future__ import annotations

import math

import torch

ROW_BLOCK = 1024


def exact_blocks(a: torch.Tensor, w: torch.Tensor):
    """(row slice, exact C rows) of A (m, k) @ W (k, n) in float64."""
    w64 = w.float().double()
    for r in range(0, a.shape[0], ROW_BLOCK):
        rows = slice(r, min(r + ROW_BLOCK, a.shape[0]))
        yield rows, a[rows].float().double() @ w64


def c_error(c: torch.Tensor, a: torch.Tensor, w: torch.Tensor) -> float:
    """Largest |C - exact A @ W| over the root mean square of the exact C;
    NaN where C holds a value that is not finite."""
    worst, squares, count = 0.0, 0.0, 0
    for rows, exact in exact_blocks(a, w):
        got = c[rows].float().double()
        if not bool(torch.isfinite(got).all()):
            return math.nan
        worst = max(worst, float((got - exact).abs().max()))
        squares += float((exact * exact).sum())
        count += exact.numel()
    return worst / math.sqrt(squares / count)


# ---------------------------------------------------------------------------
# the control: the reference computed in the nearest precision below the
# cell's (int4 for e4m3 operands, e4m3 for bf16 ones), C in the cell's dtype
# ---------------------------------------------------------------------------

def int4_rows(x: torch.Tensor) -> torch.Tensor:
    """x rounded to 4-bit integers with one symmetric scale per row (the
    absolute maximum of the row at 7), back in float64."""
    x = x.float().double()
    scale = x.abs().amax(dim=1, keepdim=True).clamp_min(1e-30) / 7
    return (x / scale).round().clamp(-8, 7) * scale


def e4m3_tensor(x: torch.Tensor) -> torch.Tensor:
    """x rounded to e4m3 with one scale for the tensor (its absolute
    maximum at e4m3's largest value, 448), back in float64."""
    x = x.float()
    scale = 448.0 / float(x.abs().max().clamp_min(1e-30))
    return (x * scale).to(torch.float8_e4m3fn).double() / scale


LOWER = {"float8_e4m3fn": int4_rows, "bfloat16": e4m3_tensor}


def control_c(a: torch.Tensor, w_stored: torch.Tensor) -> torch.Tensor:
    """The product in the precision below the operands': each operand
    quantized by rows as stored (A's rows, the weight's (n, k) rows), the
    product in float64, C rounded to the operands' dtype."""
    low = LOWER[str(a.dtype).split(".")[-1]]
    c = low(a) @ low(w_stored).T
    return c.to(a.dtype)
