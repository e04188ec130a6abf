"""Meta-device stand-ins for every (arch x shape) dry-run cell: the right
shapes and dtypes, no memory.

Port of `repro/launch/input_specs.py`, with tensors on PyTorch's meta
device where the reference has `jax.ShapeDtypeStruct`s. `train` cells take
a batch of tokens and targets; `prefill` cells the prefill forward's
tokens; `decode` cells ONE new token against caches of `seq_len`. VLM
cells add stub patch embeddings (`prefix_embeds`), encoder-decoder cells
stub frame embeddings (`encoder_embeds`; at decode, the encoder's output
`encoder_out`), bf16 as in the reference.
"""
from __future__ import annotations

from typing import Any, Dict

import torch

from repro_torch.configs.registry import SHAPES
from repro_torch.models.common import ModelConfig
from repro_torch.models.model import Model, decode_init, init_params

META = torch.device("meta")


def sds(shape, dtype) -> torch.Tensor:
    """An abstract (meta-device) tensor of `shape` and `dtype`."""
    return torch.empty(tuple(shape), dtype=dtype, device=META)


def param_shapes(cfg: ModelConfig) -> Model:
    """The model's parameters on the meta device."""
    return init_params(None, cfg, device=META)


def cache_shapes(cfg: ModelConfig, batch: int, max_len: int) -> Dict[str, Any]:
    """`decode_init`'s caches on the meta device: one list per layer group,
    where the reference stacks each group on a leading axis."""
    return decode_init(param_shapes(cfg), cfg, batch, max_len)


def input_specs(cfg: ModelConfig, shape_name: str) -> Dict[str, Any]:
    """{kind, batch, seq, and the abstract inputs}, keyed as the
    reference's."""
    spec = SHAPES[shape_name]
    b, s = spec["global_batch"], spec["seq_len"]
    kind = spec["kind"]
    out: Dict[str, Any] = {"kind": kind, "batch": b, "seq": s}
    frames = (b, cfg.n_prefix, cfg.d_model)

    if kind == "train":
        batch = {"tokens": sds((b, s), torch.int32),
                 "targets": sds((b, s), torch.int32)}
        if cfg.frontend == "vision_stub":
            batch["prefix_embeds"] = sds(frames, torch.bfloat16)
        if cfg.is_encoder_decoder:
            batch["encoder_embeds"] = sds(frames, torch.bfloat16)
        out["inputs"] = batch
    elif kind == "prefill":
        out["tokens"] = sds((b, s), torch.int32)
        if cfg.frontend == "vision_stub":
            out["prefix_embeds"] = sds(frames, torch.bfloat16)
        if cfg.is_encoder_decoder:
            out["encoder_embeds"] = sds(frames, torch.bfloat16)
    elif kind == "decode":
        out["tokens"] = sds((b, 1), torch.int32)
        out["position"] = sds((), torch.int32)
        out["caches"] = cache_shapes(cfg, b, s)
        if cfg.is_encoder_decoder:
            out["encoder_out"] = sds(frames, torch.bfloat16)
    else:
        raise ValueError(kind)
    return out
