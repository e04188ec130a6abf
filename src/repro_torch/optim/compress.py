"""Gradient compression for the cross-pod (slow-link) all-reduce.

Port of `repro/optim/compress.py`: int8 blockwise quantization with error
feedback. The gradient is quantized before the pod-axis reduction and the
quantization residual is carried into the next step. Gradients and
residuals are name -> tensor mappings (the model's parameter names).
`torch.round` rounds half to even, as `jnp.round` does.

The reference applies it to GSPMD's global gradient, in blocks of 256 over
the flattened whole tensor. With a sharded model's layout (`apply(...,
layout)`) the port computes the same numbers on the gradient the pods'
mean leaves on each rank: it gathers the whole of each sharded tensor
(within the pod), quantizes it as the reference does, and keeps this
rank's block of the result and of the residual, whatever the blocks'
boundaries. No int8 bytes cross the pods: the reference does not realise
them either.
"""
from __future__ import annotations

from typing import Dict, Mapping, NamedTuple, Tuple

import torch

from repro_torch.optim.adamw import Params, named
from repro_torch.parallel import sharded

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


def compress_decompress(g: torch.Tensor, residual: torch.Tensor,
                        placement=None) -> Tuple[torch.Tensor, torch.Tensor]:
    """One error-feedback round: returns (transmitted grad, new residual).
    With a `parallel.sharded.Placement`, `g` and `residual` are this
    rank's blocks of whole tensors, which are quantized whole."""
    acc = g.float() + residual
    whole = acc if placement is None else sharded.gather_data(acc, placement)
    q, scale = _quantize(whole)
    deq = _dequantize(q, scale, whole.shape)
    if placement is not None:
        deq = deq[placement.block()].clone()
    return deq.to(g.dtype), acc - deq


def apply(grads: Mapping[str, torch.Tensor], state: CompressState,
          layout=None) -> Tuple[Dict[str, torch.Tensor], CompressState]:
    """One round over every gradient; `layout`, a sharded model's, places
    the blocks."""
    outs = {k: compress_decompress(
        g, state.residual[k],
        None if layout is None else layout.placements[k])
        for k, g in grads.items()}
    return ({k: o[0] for k, o in outs.items()},
            CompressState(residual={k: o[1] for k, o in outs.items()}))
