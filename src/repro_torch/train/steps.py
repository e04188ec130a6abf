"""Serving step functions.

Port of the serving half of `repro/train/steps.py`: `make_serve_step` and
`make_prefill`. The training step (loss, grads, AdamW) is a later slice of
the port (ROADMAP.md, queue 1: training stack).
"""
from __future__ import annotations

from typing import Callable

from repro_torch.models.common import ModelConfig
from repro_torch.models.model import decode_step, forward


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
