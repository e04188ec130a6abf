"""Top-level model assembly.

Port of `repro/models/model.py`, every family of it: the dense GQA stacks
(gemma-2b, olmo-1b, phi4-mini, qwen3-14b, phi-3-vision), one group of
attention blocks; the MoE stacks (deepseek-moe-16b; deepseek-v2-236b,
whose attention is MLA), whose leading dense layers come before a group of
MoE blocks; zamba2, super-layers of `hybrid_attn_every` Mamba2 blocks each
followed by ONE shared attention block (the same weights every time, a KV
cache per use), then a Mamba2 tail; xLSTM, super-layers of
`slstm_every - 1` mLSTM blocks and one sLSTM block; and the
encoder-decoder (seamless), an `encoder` group run non-causal over the
projected frames, then `ln_enc`, and a `decoder` group whose blocks add
cross-attention (`ln_x`, `xattn`) to the encoder output. The stub
frontends (`vision_stub`, `audio_stub`) project precomputed patch or frame
embeddings through `frontend_proj` (d x d, routed as `frontend.proj`); a
VLM prepends them to the token sequence. The reference stacks each
group's parameters and scans over them; eagerly, a `ModuleList` per group
and a Python loop do the same work, with the reference's group names
(`layers`; `dense_layers` + `moe_layers`; `mamba_layers` + `mamba_tail` +
the unstacked `shared_attn`; `mlstm_layers` + `slstm_layers`; `encoder` +
`decoder`) and decode-cache keys (`layers`; `dense` + `moe`; `mamba` +
`mamba_tail` + `shared_attn`; `mlstm` + `slstm`; `decoder`). Entry
points:
`init_params` (an `nn.Module` drawn from a seeded `torch.Generator`),
`forward` (logits, or hidden states for the chunked training loss),
`decode_init` + `decode_step` (one-token serve step against preallocated
caches), `lm_head_weight`, `params_from_numpy`, which carries the
reference's parameter pytree into this package's model, and
`make_trainable`. Parameters are built frozen (`requires_grad=False`, as
serving wants them); the trainer turns them trainable with one call.
"""
from __future__ import annotations

from typing import Any, Dict, Iterator, List, Mapping, Optional, Tuple

import numpy as np
import torch
from torch import nn
from torch.utils.checkpoint import checkpoint, set_checkpoint_early_stop

from repro_torch.launch.mesh import resolve_device
from repro_torch.models import attention as attn
from repro_torch.models import moe as moe_lib
from repro_torch.models import shard_ctx
from repro_torch.models import ssm
from repro_torch.models.common import (ModelConfig, apply_mlp, apply_norm,
                                       dense_init, mlp_params, norm_params,
                                       normal)
from repro_torch.models.matmul import pmm


def _check_supported(cfg: ModelConfig) -> None:
    """The block patterns of the reference: attention stacks (dense, MoE,
    encoder-decoder), zamba2's hybrid and xLSTM."""
    if cfg.block_pattern not in ("attn", "mamba2_hybrid", "xlstm"):
        raise ValueError(cfg.block_pattern)


# ---------------------------------------------------------------------------
# parameters
# ---------------------------------------------------------------------------

def _attn_params(generator, cfg: ModelConfig, device):
    if cfg.attn == "mla":
        return attn.mla_params(generator, cfg, device)
    return attn.gqa_params(generator, cfg, device)


class AttnBlock(nn.Module):
    """`ln1` and `attn`; with `cross` (an encoder-decoder's decoder block)
    `ln_x` and `xattn`, cross-attention to the encoder output; `ln2` and
    `mlp`."""

    def __init__(self, generator, cfg: ModelConfig, device="cuda",
                 cross: bool = False):
        super().__init__()
        self.ln1 = norm_params(cfg, device)
        self.attn = _attn_params(generator, cfg, device)
        if cross:
            self.ln_x = norm_params(cfg, device)
            self.xattn = attn.gqa_params(generator, cfg, device)
        self.ln2 = norm_params(cfg, device)
        self.mlp = mlp_params(generator, cfg, device=device)


class MoEBlock(nn.Module):
    """An attention block whose MLP is the MoE layer."""

    def __init__(self, generator, cfg: ModelConfig, device="cuda"):
        super().__init__()
        self.ln1 = norm_params(cfg, device)
        self.attn = _attn_params(generator, cfg, device)
        self.ln2 = norm_params(cfg, device)
        self.moe = moe_lib.moe_params(generator, cfg, device)


class MixerBlock(nn.Module):
    """A recurrent block: `ln`, then its `mixer` (`ssm.Mamba2`, `ssm.MLSTM`
    or `ssm.SLSTM`), added to the residual."""

    def __init__(self, generator, cfg: ModelConfig, make_mixer,
                 device="cuda"):
        super().__init__()
        self.ln = norm_params(cfg, device)
        self.mixer = make_mixer(generator, cfg, device)


_MIXERS = {ssm.Mamba2: ssm.mamba2_mixer, ssm.MLSTM: ssm.mlstm_mixer,
           ssm.SLSTM: ssm.slstm_mixer}


def _mixer_blocks(generator, cfg: ModelConfig, make_mixer, n: int,
                  device) -> nn.ModuleList:
    return nn.ModuleList(MixerBlock(generator, cfg, make_mixer, device)
                         for _ in range(n))


def _super_layers(cfg: ModelConfig) -> Tuple[int, int, int]:
    """(super-layers, blocks of the stacked group per super-layer, tail):
    zamba2's `hybrid_attn_every` Mamba2 blocks before each use of the
    shared block and the remainder after them; xLSTM's `slstm_every - 1`
    mLSTM blocks before each sLSTM block."""
    if cfg.block_pattern == "mamba2_hybrid":
        per = cfg.hybrid_attn_every
        n_super, rem = divmod(cfg.n_layers, per)
        return n_super, per, rem
    per = cfg.slstm_every
    assert cfg.n_layers % per == 0, "xlstm layers must divide by slstm_every"
    return cfg.n_layers // per, per - 1, 0


class Model(nn.Module):
    """Parameters of a model: `embed` (vocab, d), the layer groups
    (`layers`; `dense_layers` and `moe_layers`; `mamba_layers`,
    `mamba_tail` and `shared_attn`; `mlstm_layers` and `slstm_layers`; or
    `encoder`, `decoder` and `ln_enc`), `ln_f`, `lm_head` (d, vocab) when
    embeddings are untied, and `frontend_proj` (d, d) with a stub
    frontend."""

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
        if cfg.frontend in ("vision_stub", "audio_stub"):
            # a learned projection of the precomputed patch / frame
            # embeddings the stub frontend supplies
            self.frontend_proj = dense_init(generator, cfg.d_model,
                                            cfg.d_model, cfg.dtype, device)
        if cfg.is_encoder_decoder:
            self.encoder = nn.ModuleList(
                AttnBlock(generator, cfg, device)
                for _ in range(cfg.n_encoder_layers))
            self.decoder = nn.ModuleList(
                AttnBlock(generator, cfg, device, cross=True)
                for _ in range(cfg.n_layers))
            self.ln_enc = norm_params(cfg, device)
            return
        if cfg.block_pattern == "mamba2_hybrid":
            n_super, per, rem = _super_layers(cfg)
            self.mamba_layers = _mixer_blocks(generator, cfg, ssm.Mamba2,
                                              n_super * per, device)
            if rem:
                self.mamba_tail = _mixer_blocks(generator, cfg, ssm.Mamba2,
                                                rem, device)
            # ONE shared attention block reused after every super-layer
            self.shared_attn = AttnBlock(generator, cfg, device)
            return
        if cfg.block_pattern == "xlstm":
            n_super, per, _ = _super_layers(cfg)
            self.mlstm_layers = _mixer_blocks(generator, cfg, ssm.MLSTM,
                                              n_super * per, device)
            self.slstm_layers = _mixer_blocks(generator, cfg, ssm.SLSTM,
                                              n_super, device)
            return
        if not cfg.n_experts:
            self.layers = nn.ModuleList(AttnBlock(generator, cfg, device)
                                        for _ in range(cfg.n_layers))
            return
        if cfg.n_dense_layers:
            self.dense_layers = nn.ModuleList(
                AttnBlock(generator, cfg, device)
                for _ in range(cfg.n_dense_layers))
        self.moe_layers = nn.ModuleList(
            MoEBlock(generator, cfg, device)
            for _ in range(cfg.n_layers - cfg.n_dense_layers))


# (parameter group, decode-cache key) of the attention stacks, in the
# order the layers run
_GROUPS = (("layers", "layers"), ("dense_layers", "dense"),
           ("moe_layers", "moe"), ("decoder", "decoder"))
# the groups the reference stacks on a leading axis (`shared_attn` is one
# block)
_STACKED = ("layers", "dense_layers", "moe_layers", "mamba_layers",
            "mamba_tail", "mlstm_layers", "slstm_layers", "encoder",
            "decoder")


def _groups(params: Model) -> Iterator[Tuple[str, nn.ModuleList]]:
    """(decode-cache key, blocks) of each attention layer group the model
    has that decodes against a KV cache (an encoder-decoder's `decoder`,
    not its `encoder`)."""
    for name, key in _GROUPS:
        blocks = getattr(params, name, None)
        if blocks is not None:
            yield key, blocks


def init_params(generator: Optional[torch.Generator], cfg: ModelConfig,
                device="cuda") -> Model:
    """Random parameters drawn from `generator` on `device` (fp32 normal
    draws cast to `cfg.dtype`, scaled as in the reference): the card unless
    the caller passes `device="cpu"`; with no card that raises.
    `generator=None` builds an uninitialised shell (e.g. on the meta
    device)."""
    return Model(generator, cfg, device)


def _flatten(tree: Mapping[str, Any], prefix: str = ""
             ) -> Iterator[Tuple[str, Any]]:
    for key, value in tree.items():
        name = f"{prefix}{key}"
        if isinstance(value, Mapping):
            yield from _flatten(value, name + ".")
        else:
            yield name, value


def params_from_numpy(tree: Mapping[str, Any], cfg: ModelConfig,
                      device="cuda") -> Model:
    """The reference's parameter pytree (numpy leaves, each layer group
    stacked on a leading axis: `layers`; `dense_layers` + `moe_layers`
    with their stacked expert leaves; `mamba_layers` + `mamba_tail`;
    `mlstm_layers` + `slstm_layers`; `encoder` + `decoder`, the decoder's
    blocks with `ln_x` and `xattn`) as this package's model on `device`
    (the card unless the caller passes `device="cpu"`; with no card that
    raises). Leaf paths name the parameters: block i of group G takes
    `G.<path>[i]`, zamba2's one shared block `shared_attn.<path>`, and the
    unstacked leaves (`frontend_proj`, `ln_enc`) their path. bf16
    leaves arrive as `ml_dtypes.bfloat16` and go through fp32, which is
    exact."""
    _check_supported(cfg)
    device = resolve_device(device)
    model = Model(None, cfg, device="meta")
    dtypes = {name: p.dtype for name, p in model.named_parameters()}
    stacked = set(_STACKED)

    state = {}
    for name, leaf in _flatten(tree):
        group, _, rest = name.partition(".")
        if group in stacked:
            for i in range(len(leaf)):
                state[f"{group}.{i}.{rest}"] = leaf[i]
        else:
            state[name] = leaf
    state = {name: torch.from_numpy(np.array(a, dtype=np.float32)).to(
        device=device, dtype=dtypes.get(name, torch.float32))
        for name, a in state.items()}
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

def _block(p, x: torch.Tensor, cfg: ModelConfig, positions: torch.Tensor,
           cache=None, causal: bool = True, enc_out=None):
    """An attention block (GQA, or MLA, which is always causal); with
    `enc_out`, cross-attention to it (not causal, no RoPE, no cache); then
    its MLP, or for a `MoEBlock` its MoE layer (the reference's
    `_attn_block` / `_moe_block`)."""
    h = apply_norm(p.ln1, x, cfg)
    if cfg.attn == "mla":
        a, new_cache = attn.mla_attention(p.attn, h, cfg, positions, cache)
    else:
        a, new_cache = attn.gqa_attention(p.attn, h, cfg, positions, cache,
                                          causal=causal)
    x = x + a
    if enc_out is not None:
        h = apply_norm(p.ln_x, x, cfg)
        a, _ = attn.gqa_attention(p.xattn, h, cfg, positions, None,
                                  causal=False, kv_input=enc_out)
        x = x + a
    h = apply_norm(p.ln2, x, cfg)
    if isinstance(p, MoEBlock):
        return x + moe_lib.apply_moe(p.moe, h, cfg), new_cache
    return x + apply_mlp(p.mlp, h, cfg), new_cache


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


def _layer(p, x: torch.Tensor, cfg: ModelConfig,
           positions: torch.Tensor) -> torch.Tensor:
    return shard_ctx.constrain_tokens(_block(p, x, cfg, positions)[0])


def _encoder_layer(p: AttnBlock, x: torch.Tensor, cfg: ModelConfig,
                   positions: torch.Tensor) -> torch.Tensor:
    return shard_ctx.constrain_tokens(
        _block(p, x, cfg, positions, causal=False)[0])


def _decoder_layer(p: AttnBlock, enc: torch.Tensor, x: torch.Tensor,
                   cfg: ModelConfig, positions: torch.Tensor) -> torch.Tensor:
    return shard_ctx.constrain_tokens(
        _block(p, x, cfg, positions, enc_out=enc)[0])


def _mixer_block(p: MixerBlock, x: torch.Tensor, cfg: ModelConfig,
                 state=None):
    """A recurrent block (the reference's `_mamba_block` / `_mlstm_block` /
    `_slstm_block`): its mixer's chunked form, or with `state` its
    recurrent form."""
    h = apply_norm(p.ln, x, cfg)
    # by isinstance: a sharded mixer's class gathers its weights on use
    mix = next(f for cls, f in _MIXERS.items() if isinstance(p.mixer, cls))
    y, new_state = mix(p.mixer, h, cfg, state)
    return x + y, new_state


def _mixer_layer(p: MixerBlock, x: torch.Tensor, cfg: ModelConfig,
                 positions: torch.Tensor) -> torch.Tensor:
    return shard_ctx.constrain_tokens(_mixer_block(p, x, cfg)[0])


def _super_layer(blocks, last, x: torch.Tensor, cfg: ModelConfig,
                 positions: torch.Tensor) -> torch.Tensor:
    """One super-layer of the forward: the stacked group's blocks, then
    zamba2's shared attention block at the full positions, or xLSTM's
    sLSTM block."""
    for p in blocks:
        x = _mixer_block(p, x, cfg)[0]
    if isinstance(last, AttnBlock):
        x = _block(last, x, cfg, positions)[0]
    else:
        x = _mixer_block(last, x, cfg)[0]
    return shard_ctx.constrain_tokens(x)


def _units(params: Model, cfg: ModelConfig, enc=None):
    """(fn, leading args) of each unit the forward runs in order, and remat
    wraps whole, as the reference scans them: a layer of the attention
    stacks (an encoder-decoder's decoder layers with the encoder output
    `enc`); a super-layer of the recurrent ones, then each block of the
    Mamba2 tail."""
    if cfg.is_encoder_decoder:
        for layer in params.decoder:
            yield _decoder_layer, (layer, enc)
        return
    if cfg.block_pattern == "attn":
        for _, blocks in _groups(params):
            for layer in blocks:
                yield _layer, (layer,)
        return
    n_super, per, _ = _super_layers(cfg)
    hybrid = cfg.block_pattern == "mamba2_hybrid"
    stacked = params.mamba_layers if hybrid else params.mlstm_layers
    for i in range(n_super):
        last = params.shared_attn if hybrid else params.slstm_layers[i]
        yield _super_layer, (stacked[i * per:(i + 1) * per], last)
    for layer in getattr(params, "mamba_tail", ()):
        yield _mixer_layer, (layer,)


def lm_head_weight(params: Model, cfg: ModelConfig) -> torch.Tensor:
    """(D, vocab) projection. Tied: the strided view `embed.T` — no copy;
    the `mmad` kernel reads it through its strides. Tied or not as `cfg`
    says: a test of `params.lm_head` would gather a sharded head."""
    if cfg.tie_embeddings:
        return params.embed.to(cfg.dtype).T
    return params.lm_head


def _run(units, x: torch.Tensor, cfg: ModelConfig, positions: torch.Tensor,
         remat: bool) -> torch.Tensor:
    """Each (fn, leading args) of `units` on x in order, each under
    `remat_call` when `remat`."""
    for fn, args in units:
        if remat:
            x = remat_call(fn, *args, x, cfg, positions)
        else:
            x = fn(*args, x, cfg, positions)
    return x


def _encode(params: Model, encoder_embeds: torch.Tensor, cfg: ModelConfig,
            remat: bool = False) -> torch.Tensor:
    """An encoder-decoder's encoder output: the frame embeddings (B, F, D)
    through `frontend_proj` (routed as `frontend.proj`), the `encoder`
    layers non-causal at positions 0..F-1, then `ln_enc`."""
    enc = pmm(encoder_embeds.to(cfg.dtype), params.frontend_proj,
              tag="frontend.proj")
    positions = torch.arange(enc.shape[1], device=enc.device)
    enc = _run(((_encoder_layer, (layer,)) for layer in params.encoder),
               enc, cfg, positions, remat)
    return apply_norm(params.ln_enc, enc, cfg)


def forward(params: Model, tokens: torch.Tensor, cfg: ModelConfig,
            prefix_embeds=None, encoder_embeds=None, remat: bool = True,
            return_hidden: bool = False) -> torch.Tensor:
    """Training/prefill forward -> logits (B, S, vocab) in fp32, or the
    final hidden states (B, S, D) with return_hidden=True.

    `prefix_embeds` (B, P, D): a stub frontend's patch embeddings, through
    `frontend_proj` and prepended to the sequence (S counts them; positions
    run over prefix plus tokens). `encoder_embeds` (B, F, D): an
    encoder-decoder's frame embeddings, which it needs (`_encode`).

    `remat` is the reference's scan-level `jax.checkpoint`: while autograd
    records, each layer (each super-layer of the recurrent stacks; each
    encoder and decoder layer) runs under `remat_call`, so only its inputs
    are kept and the backward recomputes it. With no gradient to record
    there is nothing to rematerialize."""
    x = shard_ctx.constrain_tokens(params.embed[tokens].to(cfg.dtype))
    if prefix_embeds is not None:
        pe = pmm(prefix_embeds.to(cfg.dtype), params.frontend_proj,
                 tag="frontend.proj")
        x = torch.cat([pe, x], dim=1)
    s = x.shape[1]
    positions = torch.arange(s, device=x.device)
    remat = remat and torch.is_grad_enabled()
    enc = None
    if cfg.is_encoder_decoder:
        if encoder_embeds is None:
            raise ValueError(f"{cfg.name} is an encoder-decoder: its forward "
                             f"needs encoder_embeds")
        enc = _encode(params, encoder_embeds, cfg, remat)
    x = _run(_units(params, cfg, enc), x, cfg, positions, remat)
    x = apply_norm(params.ln_f, x, cfg)
    if return_hidden:
        return x
    logits = pmm(x, lm_head_weight(params, cfg), tag="lm_head")
    return logits.float()


def decode_init(params: Model, cfg: ModelConfig, batch: int,
                max_len: int) -> Dict[str, Any]:
    """Preallocated per-layer caches for one-token decode steps, one list
    per layer group: KV caches (`layers`; `dense` and `moe`; an
    encoder-decoder's `decoder`, self-attention only); zamba2's
    Mamba2 states (`mamba`, `mamba_tail`) and a KV cache per use of the
    shared block (`shared_attn`, n_super of them); xLSTM's `mlstm` and
    `slstm` states."""
    _check_supported(cfg)
    device = params.embed.device
    if cfg.block_pattern == "attn":
        return {key: [attn.make_kv_cache(cfg, batch, max_len, device)
                      for _ in blocks] for key, blocks in _groups(params)}
    n_super, per, rem = _super_layers(cfg)
    if cfg.block_pattern == "xlstm":
        return {"mlstm": [ssm.mlstm_state(cfg, batch, device)
                          for _ in range(n_super * per)],
                "slstm": [ssm.slstm_state(cfg, batch, device)
                          for _ in range(n_super)]}
    caches = {"mamba": [ssm.mamba2_state(cfg, batch, device)
                        for _ in range(n_super * per)]}
    if rem:
        caches["mamba_tail"] = [ssm.mamba2_state(cfg, batch, device)
                                for _ in range(rem)]
    caches["shared_attn"] = [attn.make_kv_cache(cfg, batch, max_len, device)
                             for _ in range(n_super)]
    return caches


def _decode_recurrent(params: Model, caches: Dict[str, Any],
                      x: torch.Tensor, cfg: ModelConfig,
                      positions: torch.Tensor
                      ) -> Tuple[torch.Tensor, Dict[str, Any]]:
    """The layers of a zamba2 or xLSTM decode step, each super-layer's
    blocks on their own states, then the shared attention block on the
    super-layer's KV cache or the sLSTM block on its state; then the
    Mamba2 tail. Returns x and the new caches."""
    n_super, per, _ = _super_layers(cfg)
    hybrid = cfg.block_pattern == "mamba2_hybrid"
    key, blocks = (("mamba", params.mamba_layers) if hybrid
                   else ("mlstm", params.mlstm_layers))
    last_key = "shared_attn" if hybrid else "slstm"
    new: Dict[str, List[Any]] = {key: [], last_key: []}
    for i in range(n_super):
        for j in range(i * per, (i + 1) * per):
            x, state = _mixer_block(blocks[j], x, cfg, caches[key][j])
            new[key].append(state)
        if hybrid:
            x, cache = _block(params.shared_attn, x, cfg, positions,
                              cache=caches[last_key][i])
        else:
            x, cache = _mixer_block(params.slstm_layers[i], x, cfg,
                                    caches[last_key][i])
        new[last_key].append(cache)
    if "mamba_tail" in caches:
        new["mamba_tail"] = []
        for layer, state in zip(params.mamba_tail, caches["mamba_tail"]):
            x, state = _mixer_block(layer, x, cfg, state)
            new["mamba_tail"].append(state)
    return x, new


def decode_step(params: Model, caches: Dict[str, Any], tokens: torch.Tensor,
                position, cfg: ModelConfig, encoder_out=None
                ) -> Tuple[torch.Tensor, Dict[str, Any]]:
    """One decode step: tokens (B, 1) -> logits (B, vocab) fp32, updated
    caches. `position` is the host-side int write index (a 0-d tensor is
    read once). An encoder-decoder needs `encoder_out` (B, F, D), the
    encoder's output, which each decoder layer's cross-attention projects
    to K and V again every step (the reference keeps no cross-attention
    cache); other families take none."""
    enc = None
    if cfg.is_encoder_decoder:
        if encoder_out is None:
            raise ValueError(f"{cfg.name} is an encoder-decoder: its decode "
                             f"step needs encoder_out")
        enc = encoder_out
    x = shard_ctx.constrain_tokens(params.embed[tokens].to(cfg.dtype))
    pos = int(position)
    positions = torch.arange(pos, pos + tokens.shape[1], device=x.device)
    new_caches = dict(caches)
    if cfg.block_pattern != "attn":
        x, states = _decode_recurrent(params, caches, x, cfg, positions)
        new_caches.update(states)
    for key, blocks in _groups(params):
        new: List[Dict[str, Any]] = []
        for layer, cache in zip(blocks, caches[key]):
            x, new_cache = _block(layer, x, cfg, positions, cache=cache,
                                  enc_out=enc)
            new.append(new_cache)
        new_caches[key] = new
    x = apply_norm(params.ln_f, x, cfg)
    logits = pmm(x, lm_head_weight(params, cfg), tag="lm_head")
    return logits[:, -1].float(), new_caches
