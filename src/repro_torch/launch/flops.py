"""Analytic model-FLOPs (the 6ND side of the §Roofline MODEL_FLOPS ratio).

Port of `repro/launch/flops.py`, the same arithmetic on the port's
`ModelConfig`, with `CHUNK` read from the port's `models/ssm.py`.

MODEL_FLOPS uses the standard convention: 6 * N * D for training (fwd 2ND +
bwd 4ND) and 2 * N_active * D for inference, over ACTIVE parameters (MoE:
shared + top-k experts only; embedding table excluded, LM head included).
Attention-score FLOPs are added explicitly (they are not in N*D):
12 * B * S^2 * H * hd per layer trained (4 matmul-equivalents x fwd+bwd
factor 3), 4 * B * S^2 * H * hd for prefill, 4 * B * S * H * hd per decoded
token against an S-long cache. The sLSTM's recurrent matvec is counted
apart (`slstm_recurrent_flops`). The mLSTM's head dim is `2 * d_model // n_heads` (its inner width over its
heads), the sLSTM's `d_model // n_heads`. A frontend's prefix rows are not
tokens here: `seq` is the text (decoder) length, as in the reference.
"""
from __future__ import annotations

from typing import Dict

from repro_torch.models.common import ModelConfig


def active_params_excl_embed(cfg: ModelConfig) -> int:
    """Active parameters less the embedding table; an untied lm_head stays
    counted (it is a real matmul)."""
    return max(cfg.active_param_count() - cfg.vocab * cfg.d_model, 0)


def _attn_score_flops(cfg: ModelConfig, b: int, s: int, kind: str) -> float:
    if cfg.block_pattern == "xlstm":
        # mLSTM chunked scores are linear-attention-like: S * chunk, not S^2
        from repro_torch.models.ssm import CHUNK
        h = cfg.n_heads
        hd = 2 * cfg.d_model // h
        n_m = (cfg.n_layers // cfg.slstm_every) * (cfg.slstm_every - 1)
        per_tok = 4 * min(CHUNK, s) * h * hd
        mult = {"train": 3, "prefill": 1, "decode": 0}[kind]
        base = b * s * per_tok * n_m * mult
        # decode: recurrent update is O(hd^2) per head per token
        if kind == "decode":
            base = b * n_m * h * hd * hd * 6
        return base
    if cfg.block_pattern == "mamba2_hybrid":
        # SSD: O(S * chunk) within + O(S * N * P) state math; attention only
        # in the shared block (n_super applications)
        from repro_torch.models.ssm import CHUNK
        n_attn = cfg.n_layers // cfg.hybrid_attn_every
        hd = cfg.hd
        att = 4 * b * s * s * cfg.n_heads * hd * n_attn
        d_inner = 2 * cfg.d_model
        n_mamba = cfg.n_layers
        ssd = (b * s * (min(CHUNK, s) * 2 + 2 * cfg.ssm_state) * d_inner * 2
               * n_mamba)
        if kind == "decode":
            att = 4 * b * s * cfg.n_heads * hd * n_attn    # 1 token vs cache
            ssd = b * 2 * cfg.ssm_state * d_inner * 2 * n_mamba
        return (att + ssd) * (3 if kind == "train" else 1)
    hd = (cfg.hd if cfg.attn != "mla"
          else cfg.nope_head_dim + cfg.rope_head_dim)
    layers = cfg.n_layers + (cfg.n_encoder_layers or 0)
    per = 4 * s * s * cfg.n_heads * hd     # qk + av, fwd
    if kind == "decode":
        per = 4 * s * cfg.n_heads * hd     # 1 query vs S cache
    mult = {"train": 3, "prefill": 1, "decode": 1}[kind]
    return b * per * layers * mult


def slstm_recurrent_flops(cfg: ModelConfig, b: int, s: int,
                          kind: str) -> float:
    """The sLSTM's block-diagonal recurrent matvecs, one per token a layer."""
    if cfg.block_pattern != "xlstm":
        return 0.0
    h = cfg.n_heads
    hd = cfg.d_model // h
    n_s = cfg.n_layers // cfg.slstm_every
    per_step = 2 * h * hd * 4 * hd          # block-diag recurrence
    steps = s if kind != "decode" else 1
    mult = 3 if kind == "train" else 1
    return b * steps * per_step * n_s * mult


def model_flops(cfg: ModelConfig, batch: int, seq: int,
                kind: str) -> Dict[str, float]:
    """{"matmul", "attention", "slstm_correction", "total"} of one `kind`
    ("train", "prefill" or "decode") step of `batch` x `seq` tokens."""
    n_active = active_params_excl_embed(cfg)
    tokens = batch * seq if kind != "decode" else batch
    base = {"train": 6, "prefill": 2, "decode": 2}[kind] * n_active * tokens
    attn = _attn_score_flops(cfg, batch, seq, kind)
    slstm = slstm_recurrent_flops(cfg, batch, seq, kind)
    return {"matmul": float(base), "attention": float(attn),
            "slstm_correction": float(slstm),
            "total": float(base) + float(attn) + float(slstm)}
