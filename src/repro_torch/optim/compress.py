"""Gradient compression for the cross-pod (slow-link) all-reduce.

Port of `repro/optim/compress.py`: int8 blockwise quantization with error
feedback. The gradient is quantized before the pod-axis reduction and the
quantization residual is carried into the next step. Gradients and
residuals are name -> tensor mappings (the model's parameter names).
`torch.round` rounds half to even, as `jnp.round` does. On one device there
is no reduction to shrink, so the round trip only shapes the numerics that
multi-rank training with sharded parameters will reduce.
"""
from __future__ import annotations

from typing import Dict, Mapping, NamedTuple, Tuple

import torch

from repro_torch.optim.adamw import Params, named

BLOCK = 256


class CompressState(NamedTuple):
    residual: Dict[str, torch.Tensor]   # error-feedback carry, fp32


def init(grads_like: Params) -> CompressState:
    return CompressState(residual={
        k: torch.zeros(g.shape, dtype=torch.float32, device=g.device)
        for k, g in named(grads_like).items()})


def _quantize(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    flat = x.float().reshape(-1)
    pad = (-flat.numel()) % BLOCK
    flat = torch.nn.functional.pad(flat, (0, pad))
    blocks = flat.reshape(-1, BLOCK)
    scale = blocks.abs().amax(dim=1, keepdim=True) / 127.0 + 1e-12
    q = torch.clamp(torch.round(blocks / scale), -127, 127).to(torch.int8)
    return q, scale


def _dequantize(q: torch.Tensor, scale: torch.Tensor, shape) -> torch.Tensor:
    flat = (q.float() * scale).reshape(-1)
    size = 1
    for d in shape:
        size *= d
    return flat[:size].reshape(shape)


def compress_decompress(g: torch.Tensor, residual: torch.Tensor
                        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """One error-feedback round: returns (transmitted grad, new residual)."""
    acc = g.float() + residual
    q, scale = _quantize(acc)
    deq = _dequantize(q, scale, g.shape)
    return deq.to(g.dtype), acc - deq


def apply(grads: Mapping[str, torch.Tensor], state: CompressState
          ) -> Tuple[Dict[str, torch.Tensor], CompressState]:
    outs = {k: compress_decompress(g, state.residual[k])
            for k, g in grads.items()}
    return ({k: o[0] for k, o in outs.items()},
            CompressState(residual={k: o[1] for k, o in outs.items()}))
