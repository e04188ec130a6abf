"""Attention blocks: GQA/MQA (with qk-norm, arbitrary head_dim) and the
decode path against a preallocated KV cache.

Port of the dense half of `repro/models/attention.py`. The projection
matmuls are the DiT-scheduled GEMMs (`pmm`), and attention itself goes
through the `pattn` funnel. MLA and `chunked_sdpa` (prefill and training
over 1024 tokens) are later slices of the port (ROADMAP.md, queue 1).
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
from torch import nn

from repro_torch.launch.mesh import resolve_device
from repro_torch.models.common import (ModelConfig, apply_rope, dense_init,
                                       rms_head_norm, rope_tables)
from repro_torch.models.matmul import pattn, pmm

NEG_INF = -1e30


class GQA(nn.Module):
    """Projection weights in the reference's (K, N) layout."""

    def __init__(self, generator, cfg: ModelConfig, device="cuda"):
        super().__init__()
        hd = cfg.hd
        device = resolve_device(device)
        self.wq = dense_init(generator, cfg.d_model, cfg.n_heads * hd,
                             cfg.dtype, device)
        self.wk = dense_init(generator, cfg.d_model, cfg.n_kv_heads * hd,
                             cfg.dtype, device)
        self.wv = dense_init(generator, cfg.d_model, cfg.n_kv_heads * hd,
                             cfg.dtype, device)
        self.wo = dense_init(generator, cfg.n_heads * hd, cfg.d_model,
                             cfg.dtype, device)


def gqa_params(generator, cfg: ModelConfig, device="cuda") -> GQA:
    return GQA(generator, cfg, device)


def chunked_sdpa(q, k, v, causal: bool, chunk_q: int = 256,
                 chunk_k: int = 256, scale: Optional[float] = None):
    """The reference's flash attention for sequences over 1024 tokens."""
    raise NotImplementedError(
        "chunked_sdpa (attention over more than 1024 tokens) is not ported "
        "yet (ROADMAP.md, queue 1: attention and the model zoo)")


def _sdpa(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, causal: bool,
          q_positions: Optional[torch.Tensor] = None,
          kv_len: Optional[torch.Tensor] = None,
          scale: Optional[float] = None) -> torch.Tensor:
    """q: (B, Sq, H, D), k/v: (B, Sk, Hkv, D) with GQA head grouping.

    q_positions: positions of the queries (decode: the cache write index);
    kv_len: valid cache length mask bound (decode against a preallocated
    cache). Logits and PV accumulate in fp32, as the reference's
    `preferred_element_type` einsums do."""
    b, sq, h, d = q.shape
    sk, hkv = k.shape[1], k.shape[2]
    groups = h // hkv
    qg = q.reshape(b, sq, hkv, groups, d)
    logits = torch.einsum("bqhgd,bkhd->bhgqk", qg.float(), k.float())
    logits = logits * ((d ** -0.5) if scale is None else scale)
    kpos = torch.arange(sk, device=q.device)
    if causal:
        qpos = (q_positions if q_positions is not None
                else torch.arange(sq, device=q.device))
        mask = kpos[None, :] <= qpos[:, None]            # (sq, sk)
        logits = logits.masked_fill(~mask[None, None, None], NEG_INF)
    if kv_len is not None:
        valid = kpos[None, :] < kv_len[:, None]          # (b, sk)
        logits = logits.masked_fill(~valid[:, None, None, None], NEG_INF)
    probs = torch.softmax(logits, dim=-1).to(v.dtype)
    out = torch.einsum("bhgqk,bkhd->bqhgd", probs.float(), v.float())
    return out.to(v.dtype).reshape(b, sq, h, v.shape[-1])


def gqa_attention(p: GQA, x: torch.Tensor, cfg: ModelConfig,
                  positions: torch.Tensor,
                  cache: Optional[Dict[str, object]] = None,
                  causal: bool = True,
                  kv_input: Optional[torch.Tensor] = None,
                  ) -> Tuple[torch.Tensor, Optional[Dict[str, object]]]:
    """Self- or cross-attention. With `cache`, runs one decode step: writes
    this step's K/V at position `cache['index']` and attends to the prefix.

    The reference's `dynamic_update_slice` returns a new cache array; here
    the step's K/V are written in place into the preallocated cache tensors
    (a slice assignment), so a decode step allocates no cache-sized memory.
    The returned cache dict shares those tensors, with the advanced index."""
    if cache is not None and kv_input is not None:
        raise ValueError("gqa_attention: cache and kv_input are mutually "
                         "exclusive (cached cross-attention is not "
                         "supported; precompute encoder K/V instead)")
    b, s, _ = x.shape
    hd = cfg.hd
    kv_src = kv_input if kv_input is not None else x
    q = pmm(x, p.wq, tag="attn.q").reshape(b, s, cfg.n_heads, hd)
    k = pmm(kv_src, p.wk, tag="attn.k").reshape(
        b, kv_src.shape[1], cfg.n_kv_heads, hd)
    v = pmm(kv_src, p.wv, tag="attn.v").reshape(
        b, kv_src.shape[1], cfg.n_kv_heads, hd)
    if cfg.qk_norm:
        q, k = rms_head_norm(q), rms_head_norm(k)
    if kv_input is None:  # RoPE only for self-attention
        cos_q, sin_q = rope_tables(positions, hd, cfg.rope_theta)
        q = apply_rope(q, cos_q, sin_q)
        k = apply_rope(k, cos_q, sin_q)

    if cache is None:
        self_causal = causal and kv_input is None
        if s > 1024 and kv_src.shape[1] > 1024:
            unfused = lambda: chunked_sdpa(q, k, v, causal=self_causal)
        else:
            unfused = lambda: _sdpa(q, k, v, causal=self_causal)
        out = pattn(q, k, v, causal=self_causal, tag="attn.sdpa",
                    unfused=unfused)
        new_cache = None
    else:
        idx = int(cache["index"])
        ck, cv = cache["k"], cache["v"]
        ck[:, idx:idx + s] = k                       # in-place cache write
        cv[:, idx:idx + s] = v
        kv_len = torch.full((b,), idx + s, dtype=torch.int32, device=x.device)
        out = pattn(q, ck, cv, causal=causal, q_positions=positions,
                    kv_len=kv_len, tag="attn.decode",
                    unfused=lambda: _sdpa(q, ck, cv, causal=causal,
                                          q_positions=positions,
                                          kv_len=kv_len))
        new_cache = {"k": ck, "v": cv, "index": idx + s}
    return pmm(out.reshape(b, s, cfg.n_heads * hd), p.wo,
               tag="attn.o"), new_cache


def make_kv_cache(cfg: ModelConfig, batch: int, max_len: int,
                  device="cuda") -> Dict[str, object]:
    """Preallocated per-layer cache: K/V tensors and a host-side write index."""
    if cfg.attn == "mla":
        raise NotImplementedError(
            "MLA caches are not ported yet (ROADMAP.md, queue 1: attention "
            "and the model zoo)")
    shape = (batch, max_len, cfg.n_kv_heads, cfg.hd)
    device = resolve_device(device)
    return {
        "k": torch.zeros(shape, dtype=cfg.dtype, device=device),
        "v": torch.zeros(shape, dtype=cfg.dtype, device=device),
        "index": 0,
    }
