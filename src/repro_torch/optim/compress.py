"""Gradient compression for the cross-pod (slow-link) all-reduce.

Port of `repro/optim/compress.py`: int8 blockwise quantization with error
feedback. The gradient is quantized before the pod-axis reduction and the
quantization residual is carried into the next step. Gradients and
residuals are name -> tensor mappings (the model's parameter names).
`torch.round` rounds half to even, as `jnp.round` does.

The reference applies it to GSPMD's global gradient, in blocks of 256 over
each flattened leaf. A leaf of the reference's stacks every layer of a
layer group (`models.model._STACKED`) on a leading axis, so its blocks of
256 run across layers where one layer's tensor is not a whole number of
them (a smoke config's norm scales; qwen3-14b's qk-norm scales, 128 a
layer): the port, which names layer i of group G `G.i.<path>`, quantizes
the layers of each (G, path) concatenated in layer order, as one tensor.
With a sharded model's layout (`apply(..., layout)`) the port computes
the same numbers on the gradient the pods' mean leaves on each rank: it
gathers the whole of each sharded tensor (within the pod), quantizes it as
the reference does, and keeps this rank's block of the result and of the
residual, whatever the blocks' boundaries. No int8 bytes cross the pods:
the reference does not realise them either.
"""
from __future__ import annotations

from typing import Dict, Mapping, NamedTuple, Optional, Sequence, Tuple

import torch

from repro_torch.models.model import _STACKED
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


def _stacks(names) -> list:
    """The names as the reference's leaves hold them: the layers of one
    (group, path) of a stacked layer group in layer order, every other
    name alone."""
    stacks: Dict[tuple, list] = {}
    for name in names:
        group, _, rest = name.partition(".")
        index, _, path = rest.partition(".")
        stacked = group in _STACKED and index.isdigit() and path
        stacks.setdefault((group, path) if stacked else (name,), []).append(
            (int(index) if stacked else 0, name))
    return [[name for _, name in sorted(v)] for v in stacks.values()]


def compress_decompress(grads: Sequence[torch.Tensor],
                        residuals: Sequence[torch.Tensor],
                        placements: Optional[Sequence] = None
                        ) -> Tuple[list, list]:
    """One error-feedback round over one of the reference's leaves, given
    as its tensors in order (a stacked group's layers, or one tensor):
    returns the transmitted grads and the new residuals. With
    `parallel.sharded.Placement`s, each grad and residual is this rank's
    block of a whole tensor, which is quantized whole."""
    accs = [g.float() + r for g, r in zip(grads, residuals)]
    wholes = (accs if placements is None else
              [sharded.gather_data(a, pl) for a, pl in zip(accs, placements)])
    flat = torch.cat([w.reshape(-1) for w in wholes])
    q, scale = _quantize(flat)
    deqs = _dequantize(q, scale, flat.shape).split([w.numel()
                                                    for w in wholes])
    deqs = [d.reshape(w.shape) for d, w in zip(deqs, wholes)]
    if placements is not None:
        deqs = [d[pl.block()].clone() for d, pl in zip(deqs, placements)]
    return ([d.to(g.dtype) for d, g in zip(deqs, grads)],
            [a - d for a, d in zip(accs, deqs)])


def apply(grads: Mapping[str, torch.Tensor], state: CompressState,
          layout=None) -> Tuple[Dict[str, torch.Tensor], CompressState]:
    """One round over every gradient, each stacked group's layers
    quantized together as the reference's leaf; `layout`, a sharded
    model's, places the blocks."""
    sent, residual = {}, {}
    for names in _stacks(grads):
        out, res = compress_decompress(
            [grads[k] for k in names], [state.residual[k] for k in names],
            None if layout is None else [layout.placements[k]
                                         for k in names])
        sent.update(zip(names, out))
        residual.update(zip(names, res))
    return ({k: sent[k] for k in grads},
            CompressState(residual={k: residual[k] for k in grads}))
