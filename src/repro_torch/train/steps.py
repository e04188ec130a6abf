"""Training and serving step functions.

Port of `repro/train/steps.py`. `make_train_step` builds an optionally
microbatched step: loss -> grads (optionally int8-compressed with error
feedback) -> AdamW update. Remat is on by default: each layer, and each
loss chunk, runs under `torch.utils.checkpoint` (the reference's
`jax.checkpoint`). `make_serve_step` wraps `decode_step` for batched
requests; `make_prefill` runs the forward without remat.

The reference's step is a pure function that jit donates its buffers to;
eagerly, the step updates the parameters and the optimizer moments in
place (`optim.adamw.apply`) and returns the same objects.

On a model sharded by `parallel.sharded.shard_params` the same step runs
on every rank: each pod takes its rows of the global batch (of each
microbatch, so the microbatches hold the reference's rows), the loss and
the gradient blocks are averaged over the pods, and compression and AdamW
work on the blocks (`sharded`'s docstring has the layout). The reference
pins the logits' vocab axis to the model axis; activations are whole
within a pod in the port, so `_constrain_logits` is the identity.
"""
from __future__ import annotations

from typing import Callable, Dict, Tuple

import torch

from repro_torch.models.common import ModelConfig
from repro_torch.models.matmul import pmm
from repro_torch.models.model import (decode_step, forward, lm_head_weight,
                                      remat_call)
from repro_torch.obs.trace import profile_scope
from repro_torch.optim import adamw, compress
from repro_torch.parallel import sharded

LOSS_CHUNK = 512


def _constrain_logits(x: torch.Tensor, vocab: int) -> torch.Tensor:
    """The reference pins the logits' vocab axis to the model axis; the
    port's logits are whole within a pod, so there is nothing to pin (as
    `shard_ctx.constrain_tokens`)."""
    return x


def _xent_chunk(h_c: torch.Tensor, head_w: torch.Tensor, t_c: torch.Tensor,
                vocab: int) -> torch.Tensor:
    logits = _constrain_logits(
        pmm(h_c, head_w, tag="lm_head.chunked").float(), vocab)  # (b, c, V)
    logz = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, t_c[..., None].long())[..., 0]
    return (logz - gold).sum()


def chunked_xent(hidden: torch.Tensor, head_w: torch.Tensor,
                 targets: torch.Tensor, vocab: int,
                 chunk: int = LOSS_CHUNK) -> torch.Tensor:
    """Fused softmax-CE: project vocab logits chunk by chunk along the
    sequence, each chunk checkpointed, so the fp32 (B, S, V) tensor never
    exists (one chunk's logits at a time, in the backward too)."""
    b, s, _ = hidden.shape
    c = min(chunk, s)
    while s % c:
        c -= 1
    with profile_scope("train.loss"):
        total = torch.zeros((), dtype=torch.float32, device=hidden.device)
        for i in range(s // c):
            h_c = hidden[:, i * c:(i + 1) * c]
            t_c = targets[:, i * c:(i + 1) * c]
            if torch.is_grad_enabled():
                part = remat_call(_xent_chunk, h_c, head_w, t_c, vocab)
            else:
                part = _xent_chunk(h_c, head_w, t_c, vocab)
            total = total + part
        return total / (b * s)


def loss_fn(params, batch: Dict[str, torch.Tensor], cfg: ModelConfig,
            remat: bool = True) -> torch.Tensor:
    """Mean next-token cross-entropy of `batch` (`tokens`, `targets`, and a
    VLM's `prefix_embeds` or an encoder-decoder's `encoder_embeds`). A
    VLM's hidden states at the prefix positions are dropped before the
    loss: the targets cover the tokens only."""
    kwargs = {}
    if cfg.frontend == "vision_stub":
        kwargs["prefix_embeds"] = batch["prefix_embeds"]
    if cfg.is_encoder_decoder:
        kwargs["encoder_embeds"] = batch["encoder_embeds"]
    hidden = forward(params, batch["tokens"], cfg, remat=remat,
                     return_hidden=True, **kwargs)
    if cfg.frontend == "vision_stub":
        hidden = hidden[:, -batch["tokens"].shape[1]:]
    return chunked_xent(hidden, lm_head_weight(params, cfg),
                        batch["targets"], cfg.vocab)


def loss_and_grads(params, batch: Dict[str, torch.Tensor], cfg: ModelConfig,
                   remat: bool = True
                   ) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """(loss, name -> grad) of `loss_fn`, the reference's
    `jax.value_and_grad`; grads come in each parameter's dtype. The
    profiler sees `train.forward` (forward and loss) and `train.backward`
    (the backward, the remat recomputation inside it)."""
    ps = adamw.named(params)
    with profile_scope("train.forward"):
        loss = loss_fn(params, batch, cfg, remat=remat)
    with profile_scope("train.backward"):
        grads = torch.autograd.grad(loss, list(ps.values()))
    return loss.detach(), dict(zip(ps, grads))


def make_train_step(cfg: ModelConfig, opt: adamw.AdamWConfig,
                    microbatches: int = 1,
                    compress_grads: bool = False,
                    remat: bool = True) -> Callable:
    """Returns train_step(params, opt_state, comp_state, batch) ->
    (params, opt_state, comp_state, metrics), metrics `loss`, `lr` and
    `grad_norm`. With microbatches the batch splits along its leading axis
    and the grads are summed in fp32 and averaged, as the reference's scan
    does (so they reach the optimizer in fp32). The profiler sees the whole
    step as `train.step`."""

    def train_step(params, opt_state, comp_state, batch):
        with profile_scope("train.step"):
            return _step(params, opt_state, comp_state, batch)

    def _step(params, opt_state, comp_state, batch):
        layout = sharded.layout_of(params)

        def share(b):
            return b if layout is None else sharded.pod_batch(b, layout)

        if microbatches > 1:
            micro = {k: v.reshape(microbatches, v.shape[0] // microbatches,
                                  *v.shape[1:]) for k, v in batch.items()}
            loss = grads = None
            for i in range(microbatches):
                mb_loss, mb_grads = loss_and_grads(
                    params, share({k: v[i] for k, v in micro.items()}), cfg,
                    remat)
                if grads is None:
                    loss = mb_loss
                    grads = {k: g.float() for k, g in mb_grads.items()}
                else:
                    loss = loss + mb_loss
                    for k, g in mb_grads.items():
                        grads[k].add_(g)
                del mb_grads
            loss = loss / microbatches
            grads = {k: g / microbatches for k, g in grads.items()}
        else:
            loss, grads = loss_and_grads(params, share(batch), cfg, remat)

        if layout is not None:
            loss = sharded.mean_over_pods(loss, layout)
            for g in grads.values():
                sharded.mean_over_pods(g, layout)
        if compress_grads:
            grads, comp_state = compress.apply(grads, comp_state, layout)

        params, opt_state, metrics = adamw.apply(opt, params, grads, opt_state)
        metrics["loss"] = loss
        return params, opt_state, comp_state, metrics

    return train_step


def make_serve_step(cfg: ModelConfig) -> Callable:
    """serve_step(params, caches, tokens, position[, encoder_out]) ->
    (next_token_logits, caches) — ONE new token against the running cache."""

    def serve_step(params, caches, tokens, position, encoder_out=None):
        return decode_step(params, caches, tokens, position, cfg,
                           encoder_out=encoder_out)

    return serve_step


def make_prefill(cfg: ModelConfig) -> Callable:
    """prefill(params, tokens[, extras]) -> logits."""

    def prefill(params, tokens, prefix_embeds=None, encoder_embeds=None):
        return forward(params, tokens, cfg, remat=False,
                       prefix_embeds=prefix_embeds,
                       encoder_embeds=encoder_embeds)

    return prefill
