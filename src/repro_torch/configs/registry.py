"""Architecture registry: the 10 assigned architectures (exact configs from
the brief, [source] tags inline) + reduced smoke variants + the paper's own
GEMM benchmark shapes. `--arch <id>` everywhere resolves through here."""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict, List

from repro_torch.models.common import ModelConfig

_REGISTRY: Dict[str, Callable[[], ModelConfig]] = {}


def register(name: str):
    def deco(fn):
        _REGISTRY[name] = fn
        return fn
    return deco


def get_config(name: str) -> ModelConfig:
    if name not in _REGISTRY:
        raise KeyError(f"unknown arch {name!r}; have {sorted(_REGISTRY)}")
    return _REGISTRY[name]()


def list_archs() -> List[str]:
    return sorted(a for a in _REGISTRY if not a.endswith("-smoke"))


def smoke_config(name: str) -> ModelConfig:
    """Reduced same-family config: small layers/width/experts/tables."""
    return get_config(f"{name}-smoke")


# -- shape suite (the brief's per-arch input shapes) -------------------------

SHAPES = {
    "train_4k": dict(seq_len=4096, global_batch=256, kind="train"),
    "prefill_32k": dict(seq_len=32768, global_batch=32, kind="prefill"),
    "decode_32k": dict(seq_len=32768, global_batch=128, kind="decode"),
    "long_500k": dict(seq_len=524288, global_batch=1, kind="decode"),
}

# archs with sub-quadratic decode state run long_500k; pure full-attention
# archs skip it (DESIGN.md §4 'Shape skips').
SUBQUADRATIC = {"zamba2-1.2b", "xlstm-1.3b"}


def cells(arch: str) -> List[str]:
    out = []
    for shape in SHAPES:
        if shape == "long_500k" and arch not in SUBQUADRATIC:
            continue
        out.append(shape)
    return out
