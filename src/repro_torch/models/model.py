"""Top-level model assembly.

Port of `repro/models/model.py` for the dense `block_pattern == "attn"`
family without experts, frontend or encoder (gemma-2b and its kin). The
reference stacks layer parameters and scans over them; eagerly, a
`ModuleList` of blocks and a Python loop do the same work. Entry points:
`init_params` (an `nn.Module` drawn from a seeded `torch.Generator`),
`forward` (logits, or hidden states for the chunked training loss),
`decode_init` + `decode_step` (one-token serve step against preallocated
caches), `lm_head_weight`, `params_from_numpy`, which carries the
reference's parameter pytree into this package's model, and
`make_trainable`. Parameters are built frozen (`requires_grad=False`, as
serving wants them); the trainer turns them trainable with one call.
Other families raise `NotImplementedError` naming their ROADMAP.md item.
"""
from __future__ import annotations

from typing import Any, Dict, Mapping, Optional, Tuple

import numpy as np
import torch
from torch import nn
from torch.utils.checkpoint import checkpoint, set_checkpoint_early_stop

from repro_torch.launch.mesh import resolve_device
from repro_torch.models import attention as attn
from repro_torch.models import shard_ctx
from repro_torch.models.common import (ModelConfig, apply_mlp, apply_norm,
                                       dense_init, mlp_params, norm_params,
                                       normal)
from repro_torch.models.matmul import pmm

_ROADMAP_ZOO = "ROADMAP.md, queue 1: attention and the model zoo"


def _check_supported(cfg: ModelConfig) -> None:
    """This slice ports the dense attention family only."""
    if cfg.is_encoder_decoder:
        raise NotImplementedError(f"encoder-decoder stacks are not ported "
                                  f"yet ({_ROADMAP_ZOO})")
    if cfg.block_pattern != "attn":
        raise NotImplementedError(f"block pattern {cfg.block_pattern!r} "
                                  f"(SSM / xLSTM) is not ported yet "
                                  f"({_ROADMAP_ZOO})")
    if cfg.n_experts:
        raise NotImplementedError(f"MoE blocks are not ported yet "
                                  f"({_ROADMAP_ZOO})")
    if cfg.attn != "gqa":
        raise NotImplementedError(f"{cfg.attn!r} attention is not ported yet "
                                  f"({_ROADMAP_ZOO})")
    if cfg.frontend != "none":
        raise NotImplementedError(f"the {cfg.frontend!r} frontend is not "
                                  f"ported yet ({_ROADMAP_ZOO})")


# ---------------------------------------------------------------------------
# parameters
# ---------------------------------------------------------------------------

class AttnBlock(nn.Module):
    def __init__(self, generator, cfg: ModelConfig, device="cuda"):
        super().__init__()
        self.ln1 = norm_params(cfg, device)
        self.attn = attn.gqa_params(generator, cfg, device)
        self.ln2 = norm_params(cfg, device)
        self.mlp = mlp_params(generator, cfg, device=device)


class Model(nn.Module):
    """Parameters of a dense decoder: `embed` (vocab, d), `layers`, `ln_f`,
    and `lm_head` (d, vocab) when embeddings are untied."""

    def __init__(self, generator, cfg: ModelConfig, device="cuda"):
        super().__init__()
        _check_supported(cfg)
        device = resolve_device(device)
        embed = (normal(generator, (cfg.vocab, cfg.d_model), device)
                 * cfg.d_model ** -0.5)
        self.embed = nn.Parameter(embed.to(cfg.dtype), requires_grad=False)
        self.ln_f = norm_params(cfg, device)
        self.lm_head = (None if cfg.tie_embeddings else dense_init(
            generator, cfg.d_model, cfg.vocab, cfg.dtype, device))
        self.layers = nn.ModuleList(AttnBlock(generator, cfg, device)
                                    for _ in range(cfg.n_layers))


def init_params(generator: Optional[torch.Generator], cfg: ModelConfig,
                device="cuda") -> Model:
    """Random parameters drawn from `generator` on `device` (fp32 normal
    draws cast to `cfg.dtype`, scaled as in the reference): the card unless
    the caller passes `device="cpu"`; with no card that raises.
    `generator=None` builds an uninitialised shell (e.g. on the meta
    device)."""
    return Model(generator, cfg, device)


def params_from_numpy(tree: Mapping[str, Any], cfg: ModelConfig,
                      device="cuda") -> Model:
    """The reference's parameter pytree (numpy leaves, layers stacked on a
    leading axis) as this package's model on `device` (the card unless the
    caller passes `device="cpu"`; with no card that raises). bf16 leaves
    arrive as `ml_dtypes.bfloat16` and go through fp32, which is exact."""
    _check_supported(cfg)
    device = resolve_device(device)
    model = Model(None, cfg, device="meta")

    def t(a, dtype):
        return torch.from_numpy(np.array(a, dtype=np.float32)).to(
            device=device, dtype=dtype)

    state = {"embed": t(tree["embed"], cfg.dtype)}
    if model.ln_f.scale is not None:
        state["ln_f.scale"] = t(tree["ln_f"]["scale"], torch.float32)
    if model.lm_head is not None:
        state["lm_head"] = t(tree["lm_head"], cfg.dtype)
    layers = tree["layers"]
    for i in range(cfg.n_layers):
        pre = f"layers.{i}."
        for ln in ("ln1", "ln2"):
            if layers[ln]:
                state[pre + ln + ".scale"] = t(layers[ln]["scale"][i],
                                               torch.float32)
        for name in ("wq", "wk", "wv", "wo"):
            state[pre + "attn." + name] = t(layers["attn"][name][i], cfg.dtype)
        for name in ("gate", "up", "down"):
            state[pre + "mlp." + name] = t(layers["mlp"][name][i], cfg.dtype)
    model.load_state_dict(state, strict=True, assign=True)
    for p in model.parameters():
        p.requires_grad_(False)
    return model


def make_trainable(params: Model) -> Model:
    """Turn every parameter trainable (`requires_grad=True`), in place; the
    tied `embed` then takes gradient through both the token gather and the
    `embed.T` view of `lm_head_weight`."""
    for p in params.parameters():
        p.requires_grad_(True)
    return params


# ---------------------------------------------------------------------------
# blocks and entry points
# ---------------------------------------------------------------------------

def _attn_block(p: AttnBlock, x: torch.Tensor, cfg: ModelConfig,
                positions: torch.Tensor, cache=None, causal: bool = True):
    h = apply_norm(p.ln1, x, cfg)
    a, new_cache = attn.gqa_attention(p.attn, h, cfg, positions, cache,
                                      causal=causal)
    x = x + a
    h = apply_norm(p.ln2, x, cfg)
    x = x + apply_mlp(p.mlp, h, cfg)
    return x, new_cache


def remat_call(fn, *args):
    """`fn(*args)` under `torch.utils.checkpoint` (non-reentrant), as
    `jax.checkpoint(fn)`: its activations are dropped and the backward runs
    it again. The recomputation runs `fn` whole: PyTorch's early stop would
    abandon it once the backward's last saved tensor is rebuilt, which for
    a layer is after its final matmul has run but before that routed
    dispatch returns, so the kernel would run for a dispatch the routing
    counters never see."""
    with set_checkpoint_early_stop(False):
        return checkpoint(fn, *args, use_reentrant=False)


def _layer(p: AttnBlock, x: torch.Tensor, cfg: ModelConfig,
           positions: torch.Tensor) -> torch.Tensor:
    return shard_ctx.constrain_tokens(_attn_block(p, x, cfg, positions)[0])


def lm_head_weight(params: Model, cfg: ModelConfig) -> torch.Tensor:
    """(D, vocab) projection. Tied: the strided view `embed.T` — no copy;
    the `mmad` kernel reads it through its strides."""
    if params.lm_head is None:
        return params.embed.to(cfg.dtype).T
    return params.lm_head


def forward(params: Model, tokens: torch.Tensor, cfg: ModelConfig,
            prefix_embeds=None, encoder_embeds=None, remat: bool = True,
            return_hidden: bool = False) -> torch.Tensor:
    """Training/prefill forward -> logits (B, S, vocab) in fp32, or the
    final hidden states (B, S, D) with return_hidden=True.

    `remat` is the reference's scan-level `jax.checkpoint`: while autograd
    records, each layer runs under `remat_call`, so only the layer inputs
    are kept and the backward recomputes each layer. With no gradient to
    record there is nothing to rematerialize."""
    if prefix_embeds is not None or encoder_embeds is not None:
        raise NotImplementedError(f"frontend and encoder inputs are not "
                                  f"ported yet ({_ROADMAP_ZOO})")
    x = shard_ctx.constrain_tokens(params.embed[tokens].to(cfg.dtype))
    s = x.shape[1]
    positions = torch.arange(s, device=x.device)
    remat = remat and torch.is_grad_enabled()
    for layer in params.layers:
        if remat:
            x = remat_call(_layer, layer, x, cfg, positions)
        else:
            x = _layer(layer, x, cfg, positions)
    x = apply_norm(params.ln_f, x, cfg)
    if return_hidden:
        return x
    logits = pmm(x, lm_head_weight(params, cfg), tag="lm_head")
    return logits.float()


def decode_init(params: Model, cfg: ModelConfig, batch: int,
                max_len: int) -> Dict[str, Any]:
    """Preallocated per-layer KV caches for one-token decode steps."""
    _check_supported(cfg)
    device = params.embed.device
    return {"layers": [attn.make_kv_cache(cfg, batch, max_len, device)
                       for _ in range(cfg.n_layers)]}


def decode_step(params: Model, caches: Dict[str, Any], tokens: torch.Tensor,
                position, cfg: ModelConfig, encoder_out=None
                ) -> Tuple[torch.Tensor, Dict[str, Any]]:
    """One decode step: tokens (B, 1) -> logits (B, vocab) fp32, updated
    caches. `position` is the host-side int write index (a 0-d tensor is
    read once)."""
    if encoder_out is not None:
        raise NotImplementedError(f"encoder-decoder decode is not ported yet "
                                  f"({_ROADMAP_ZOO})")
    x = shard_ctx.constrain_tokens(params.embed[tokens].to(cfg.dtype))
    pos = int(position)
    positions = torch.arange(pos, pos + tokens.shape[1], device=x.device)
    new_layers = []
    for layer, cache in zip(params.layers, caches["layers"]):
        x, new_cache = _attn_block(layer, x, cfg, positions, cache=cache)
        new_layers.append(new_cache)
    x = apply_norm(params.ln_f, x, cfg)
    logits = pmm(x, lm_head_weight(params, cfg), tag="lm_head")
    return logits[:, -1].float(), dict(caches, layers=new_layers)
