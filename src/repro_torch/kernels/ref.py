"""Plain PyTorch versions of the kernels: the CPU path, and the yardstick the
CUDA kernels are held against on the card. They repeat each kernel's
arithmetic (fp32 accumulation, one rounding to the output dtype) with stock
PyTorch ops, so they are no yardstick of speed."""
from __future__ import annotations

from typing import Optional

import torch


def mmad_ref(a: torch.Tensor, b: torch.Tensor,
             out_dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """C = A @ B with float32 accumulation — the MMAD plain version.

    Every supported input dtype converts exactly to fp32, and an fp32
    `torch.matmul` is IEEE fp32 unless the caller enabled TF32."""
    out_dtype = out_dtype or a.dtype
    return torch.matmul(a.float(), b.float()).to(out_dtype)


def splitk_ref(a: torch.Tensor, b: torch.Tensor, splits: int,
               out_dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """Split-K plain version: partial GEMMs over K slices, then a sum in
    slice order — mirrors the NoC reduction semantics (fp32 partials)."""
    out_dtype = out_dtype or a.dtype
    k = a.shape[-1]
    assert k % splits == 0
    ks = k // splits
    parts = [torch.matmul(a[..., i * ks:(i + 1) * ks].float(),
                          b[i * ks:(i + 1) * ks, :].float())
             for i in range(splits)]
    return sum(parts).to(out_dtype)


def flash_attention_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                        causal: bool = True,
                        scale: Optional[float] = None) -> torch.Tensor:
    """Softmax attention plain version (fp32 softmax), [heads, seq, head_dim]."""
    if scale is None:
        scale = q.shape[-1] ** -0.5
    logits = torch.einsum("...qd,...kd->...qk", q.float(), k.float()) * scale
    if causal:
        sq, sk = logits.shape[-2], logits.shape[-1]
        mask = torch.ones((sq, sk), dtype=torch.bool,
                          device=q.device).tril(diagonal=sk - sq)
        logits = logits.masked_fill(~mask, float("-inf"))
    probs = torch.softmax(logits, dim=-1)
    return torch.einsum("...qk,...kd->...qd",
                        probs.to(v.dtype).float(), v.float()).to(v.dtype)
