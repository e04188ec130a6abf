"""Sharding rule table: parameter, batch and cache specs for the production
mesh — the data-layout half of the DiT schedule at pod scale.

Port of `repro/parallel/spec_rules.py`. A spec is a tuple with one entry
per dimension, as a `jax.sharding.PartitionSpec` has: None (replicated),
an axis name, or a tuple of axis names (major first). A mesh is anything
with `.shape` (axis name -> size) and `.axis_names`: a `DistMesh`, or a
jax `AbstractMesh` in the tests.

Policy (the reference's): 2-D FSDP x TP. Weight matrices shard their
input dim over 'data' (FSDP, gathered on use) and their output dim over
'model' (TP). MoE experts shard the expert dim over 'model' (EP) and
d_model over 'data'. Every rule is fitted: an axis that does not divide
its dim is dropped. The 'pod' axis is pure DP and never appears in a
weight spec.

The layouts differ from the reference's. It stacks each layer group on a
leading axis and pads its rules with None there; the port keeps one
module (and one cache dict) per layer, so its leaves have no layer axis
and the rules below index the port's own dims. Parameters are matched by
the last component of their `Model.named_parameters()` name, expert
tensors by an `experts` component, as in the reference's pytree paths.

The step itself is not partitioned yet (every rank holds its operands
whole): the dry run uses these specs for its per-device memory section
(`local_shape`).
"""
from __future__ import annotations

import math
from typing import Any, Dict, Iterator, Optional, Tuple, Union

import torch

from repro_torch.models.common import ModelConfig

Entry = Optional[Union[str, Tuple[str, ...]]]
Spec = Tuple[Entry, ...]


def dp_axes(mesh) -> Tuple[str, ...]:
    return ("pod", "data") if "pod" in mesh.axis_names else ("data",)


def _entry_size(entry: Entry, mesh) -> int:
    if entry is None:
        return 1
    names = entry if isinstance(entry, tuple) else (entry,)
    return math.prod(int(mesh.shape[n]) for n in names)


def _fit(spec: Spec, shape: Tuple[int, ...], mesh) -> Spec:
    """Drop spec axes that don't divide the corresponding dim."""
    out = []
    entries = list(spec) + [None] * (len(shape) - len(spec))
    for dim, entry in zip(shape, entries):
        if entry is None:
            out.append(None)
            continue
        out.append(entry if dim % _entry_size(entry, mesh) == 0 else None)
    return tuple(out)


# rules keyed by the LAST name component (parameter name); specs refer to
# the leaf's dims
_W_IN = ("data", "model")      # (d_in, d_out) column-parallel
_W_OUT = ("model", "data")     # (d_in, d_out) row-parallel

PARAM_RULES: Dict[str, Spec] = {
    "embed": ("model", "data"),           # vocab-parallel embedding
    "lm_head": ("data", "model"),
    "frontend_proj": _W_IN,
    # attention
    "wq": _W_IN, "wk": _W_IN, "wv": _W_IN, "wo": _W_OUT,
    "w_dq": _W_IN, "w_uq": _W_IN, "w_dkv": _W_IN, "w_kr": _W_IN,
    "w_uk": _W_IN, "w_uv": _W_IN,
    # mlp
    "gate": _W_IN, "up": _W_IN, "down": _W_OUT,
    # moe
    "router": ("data", None),
    # ssm / xlstm
    "w_in": _W_IN, "w_out": _W_OUT, "conv": (None, "model"),
    "a_log": (None,), "d_skip": (None,), "dt_bias": (None,),
    "w_up": _W_IN, "w_q": _W_IN, "w_k": _W_IN, "w_v": _W_IN,
    "w_gates": ("data", None), "w_down": _W_OUT,
    "r": (None,),
    # norms
    "scale": (None,),
}

# MoE expert tensors are 3-D (E, d_in, d_out): EP over 'model' + FSDP 'data'.
MOE_EXPERT_RULES: Dict[str, Spec] = {
    "gate": ("model", "data", None),
    "up": ("model", "data", None),
    "down": ("model", None, "data"),
}


def param_spec(name: str, shape: Tuple[int, ...], mesh) -> Spec:
    """The spec of parameter `name` (a dotted `named_parameters()` name)
    of `shape`."""
    keys = name.split(".")
    rule = (MOE_EXPERT_RULES if "experts" in keys else PARAM_RULES).get(
        keys[-1], ())
    # leading dims beyond the rule's (none in the port's layout) get None
    extra = len(shape) - len(rule)
    if extra > 0:
        rule = (None,) * extra + tuple(rule)
    return _fit(rule, tuple(shape), mesh)


def param_shardings(params: Any, mesh) -> Dict[str, Spec]:
    """name -> spec of every parameter of a `Model`, or of a name -> tensor
    mapping (AdamW's moments share their parameter's spec)."""
    items = (params.items() if isinstance(params, dict)
             else params.named_parameters())
    return {name: param_spec(name, tuple(t.shape), mesh)
            for name, t in items}


# ---------------------------------------------------------------------------
# batch / cache specs
# ---------------------------------------------------------------------------

def batch_spec(mesh) -> Spec:
    """Token batches: batch over all DP axes."""
    return (dp_axes(mesh), None)


def cache_spec(name: str, shape: Tuple[int, ...], mesh, cfg: ModelConfig,
               batch: int) -> Spec:
    """Decode caches (one layer's entry `name`, batch first): batch over DP
    when it divides; otherwise shard the sequence (long_500k, batch 1) or
    the head/state dims over 'model'."""
    dp = dp_axes(mesh)
    batch_ok = batch % _entry_size(dp, mesh) == 0
    bdim = dp if batch_ok else None
    shape = tuple(shape)
    if name in ("k", "v"):          # (B, S, n_kv, hd)
        # prefer kv-head sharding over 'model'; GQA archs with n_kv <
        # |model| fall back to SEQUENCE sharding (the cache is by far the
        # largest decode tensor)
        if shape[2] % int(mesh.shape["model"]) == 0:
            return _fit((bdim, None, "model", None), shape, mesh)
        return _fit((bdim, "model", None, None), shape, mesh)
    if name == "c_kv":              # (B, S, r)
        return _fit((bdim, None if batch_ok else "data", "model"), shape,
                    mesh)
    if name == "k_rope":            # (B, S, 1, dr)
        return _fit((bdim, None if batch_ok else "data", None, None), shape,
                    mesh)
    if name in ("h", "c", "n", "m"):
        # mamba (B, H, N, P); slstm (B, H, hd); mlstm states (B, H, ...)
        return _fit((bdim, "model"), shape, mesh)
    if name == "conv":              # (B, 3, C)
        return _fit((bdim, None, "model"), shape, mesh)
    return (None,) * len(shape)


def cache_leaves(caches: Dict[str, Any]
                 ) -> Iterator[Tuple[str, str, torch.Tensor]]:
    """(path, entry name, tensor) of every tensor in a `decode_init` cache
    dict (`group.i.name`); host-side ints (the write `index`) are not
    device arguments and are skipped."""
    for group, layers in caches.items():
        for i, layer in enumerate(layers):
            for name, t in layer.items():
                if isinstance(t, torch.Tensor):
                    yield f"{group}.{i}.{name}", name, t


def cache_shardings(caches: Dict[str, Any], mesh, cfg: ModelConfig,
                    batch: int) -> Dict[str, Spec]:
    """path -> spec of every tensor of a `decode_init` cache dict."""
    return {path: cache_spec(name, tuple(t.shape), mesh, cfg, batch)
            for path, name, t in cache_leaves(caches)}


def local_shape(shape: Tuple[int, ...], spec: Spec, mesh) -> Tuple[int, ...]:
    """The per-device block shape of a tensor of `shape` under `spec`
    (every entry divides its dim: specs here are fitted)."""
    entries = list(spec) + [None] * (len(shape) - len(spec))
    out = []
    for dim, entry in zip(shape, entries):
        n = _entry_size(entry, mesh)
        if dim % n:
            raise ValueError(f"dim {dim} does not divide over {entry} "
                             f"({n} devices)")
        out.append(dim // n)
    return tuple(out)


def local_bytes(t: torch.Tensor, spec: Spec, mesh) -> int:
    """Bytes one device holds of `t` under `spec`."""
    return math.prod(local_shape(tuple(t.shape), spec, mesh)) \
        * t.element_size()
