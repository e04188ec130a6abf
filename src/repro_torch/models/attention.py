"""Attention blocks: GQA/MQA (with qk-norm, arbitrary head_dim), DeepSeek-V2
MLA, and the decode path against a preallocated KV cache.

Port of `repro/models/attention.py`. The projection matmuls are the
DiT-scheduled GEMMs (`pmm`), and attention itself goes through the `pattn`
funnel; past 1024 tokens its unfused form is `chunked_sdpa`, the
reference's flash attention.
"""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch
from torch import nn

from repro_torch.launch.mesh import resolve_device
from repro_torch.models.common import (ModelConfig, apply_rope, dense_init,
                                       rms_head_norm, rope_tables)
from repro_torch.models.matmul import pattn, pmm, record_gemm

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


def _chunk(s: int, target: int) -> int:
    """Chunk size for a length-`s` axis: the target, capped at `s`. The
    tail block is padded up to a full chunk and masked, so the chunk count
    stays O(s / target) for every length."""
    return max(1, min(target, s))


def _causal_skip(qi: int, kj: int, cq: int, ck: int) -> bool:
    """Whether key block `kj` lies wholly after query block `qi` (every
    logit masked). Such a block adds exactly nothing: its p is exp(-1e30 -
    m) = 0 and its correction exp(0) = 1, forward and backward, so the
    loops leave it out where the reference computes and masks it."""
    return kj * ck > qi * cq + cq - 1


class _Flash(torch.autograd.Function):
    """The reference's `_flash` custom_vjp on (b*hkv, s, g, d) blocks.

    Forward: online softmax over key blocks for each query block, running
    max and sum in fp32; saves q, k, v, out and lse, O(S). Backward:
    recomputes each block's p from lse, as the reference's
    `_flash_vjp_bwd`. `tc`, a 16-bit dtype, takes bf16 (or fp16) products
    with fp32 sums and fp32 out on the card (the reference's
    DEFAULT-precision einsums on its chip); None keeps every product fp32,
    as the reference's."""

    @staticmethod
    def forward(ctx, q, k, v, causal, scale, cq, ck, sk_valid, tc):
        bh, sq_p, g, d = q.shape
        dv = v.shape[-1]
        nq, nk = sq_p // cq, k.shape[1] // ck
        out = torch.empty((bh, sq_p, g, dv), dtype=torch.float32,
                          device=q.device)
        lse = torch.empty((bh, sq_p, g), dtype=torch.float32,
                          device=q.device)
        for qi in range(nq):
            q_blk = q[:, qi * cq:(qi + 1) * cq].reshape(bh, cq * g, d)
            m_run = torch.full((bh, cq, g), NEG_INF, dtype=torch.float32,
                               device=q.device)
            l_run = torch.zeros_like(m_run)
            acc = torch.zeros((bh, cq * g, dv), dtype=torch.float32,
                              device=q.device)
            for kj in range(nk):
                if causal and _causal_skip(qi, kj, cq, ck):
                    continue
                logits = _block_logits(q_blk, k, qi, kj, causal, scale, cq,
                                       ck, g, sk_valid, tc)
                m_new = torch.maximum(m_run, logits.amax(-1))
                p = torch.exp(logits - m_new[..., None])
                corr = torch.exp(m_run - m_new)
                l_run = l_run * corr + p.sum(-1)
                acc = (acc.view(bh, cq, g, dv) * corr[..., None]).view(
                    bh, cq * g, dv) + _mm(p.view(bh, cq * g, ck),
                                          v[:, kj * ck:(kj + 1) * ck], tc)
                m_run = m_new
            l_safe = torch.clamp(l_run, min=1e-30)
            out[:, qi * cq:(qi + 1) * cq] = (
                acc.view(bh, cq, g, dv) / l_safe[..., None])
            lse[:, qi * cq:(qi + 1) * cq] = m_run + torch.log(l_safe)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.args = (causal, scale, cq, ck, sk_valid, tc)
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, out, lse = ctx.saved_tensors
        causal, scale, cq, ck, sk_valid, tc = ctx.args
        bh, sq_p, g, d = q.shape
        dv = v.shape[-1]
        nq, nk = sq_p // cq, k.shape[1] // ck
        dout = dout.float()
        delta = (dout * out).sum(-1)                       # (bh, sq_p, g)
        dq = torch.zeros(q.shape, dtype=torch.float32, device=q.device)
        dk = torch.zeros(k.shape, dtype=torch.float32, device=q.device)
        dv_ = torch.zeros(v.shape, dtype=torch.float32, device=q.device)
        for qi in range(nq):
            rows = slice(qi * cq, (qi + 1) * cq)
            q_blk = q[:, rows].reshape(bh, cq * g, d)
            do_blk = dout[:, rows].reshape(bh, cq * g, dv)
            lse_blk, dl_blk = lse[:, rows, :, None], delta[:, rows, :, None]
            dq_blk = dq[:, rows].view(bh, cq * g, d)
            for kj in range(nk):
                if causal and _causal_skip(qi, kj, cq, ck):
                    continue
                cols = slice(kj * ck, (kj + 1) * ck)
                logits = _block_logits(q_blk, k, qi, kj, causal, scale, cq,
                                       ck, g, sk_valid, tc)
                p = torch.exp(logits - lse_blk)            # (bh, cq, g, ck)
                dp = _mm(do_blk, v[:, cols].mT, tc).view(bh, cq, g, ck)
                ds = (p * (dp - dl_blk) * scale).view(bh, cq * g, ck)
                dq_blk += _mm(ds, k[:, cols], tc)
                dk[:, cols] += _mm(ds.mT, q_blk, tc)
                dv_[:, cols] += _mm(p.view(bh, cq * g, ck).mT, do_blk, tc)
        return (dq.to(q.dtype), dk.to(k.dtype), dv_.to(v.dtype), None, None,
                None, None, None, None)


def _mm(x: torch.Tensor, y: torch.Tensor, tc) -> torch.Tensor:
    """Batched x @ y with an fp32 result. `tc` is None (fp32 operands) or
    the 16-bit dtype both operands round to for tensor-core products."""
    if tc is not None:
        return torch.ops.aten.bmm.dtype(x.to(tc), y.to(tc), torch.float32)
    return torch.bmm(x.float(), y.float())


def _block_logits(q_blk, k, qi, kj, causal, scale, cq, ck, g, sk_valid,
                  tc) -> torch.Tensor:
    """Scaled, masked logits of query block `qi` against key block `kj`:
    (bh, cq, g, ck) fp32. Key positions >= `sk_valid` are tail padding.
    The causal mask is applied only to blocks that cross the diagonal: one
    whose last key precedes its first query masks nothing."""
    bh = q_blk.shape[0]
    k_blk = k[:, kj * ck:(kj + 1) * ck]
    logits = (_mm(q_blk, k_blk.mT, tc) * scale).view(bh, cq, g, ck)
    kpos = kj * ck + torch.arange(ck, device=k.device)
    if causal and (kj + 1) * ck - 1 > qi * cq:
        qpos = qi * cq + torch.arange(cq, device=k.device)
        mask = kpos[None, :] <= qpos[:, None]
        logits = logits.masked_fill(~mask[None, :, None, :], NEG_INF)
    if (kj + 1) * ck > sk_valid:
        logits = logits.masked_fill(~(kpos < sk_valid)[None, None, None, :],
                                    NEG_INF)
    return logits


def chunked_sdpa(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                 causal: bool, chunk_q: int = 256, chunk_k: int = 256,
                 scale: Optional[float] = None) -> torch.Tensor:
    """Flash attention over query and key chunks, never materializing the
    (Sq, Sk) logits: O(S) memory in both directions (the backward
    recomputes each block from the saved log-sum-exp). The memory-feasible
    path past 1024 tokens: 4k training, 32k prefill.

    q: (B, Sq, H, D); k/v: (B, Sk, Hkv, D) with GQA head grouping. Ragged
    lengths pad the tail chunk; padded key positions are masked, padded
    query rows sliced off (their cotangent is zero). CPU tensors compute
    in fp32 as the reference does; bf16 or fp16 tensors on the card take
    16-bit products with fp32 sums (`core.attention`'s rule for the routed
    attention einsums)."""
    from repro_torch.core.attention import _tensor_core_einsums
    from repro_torch.models import accounting
    b, sq, h, d = q.shape
    _, sk, hkv, _ = k.shape
    dv = v.shape[-1]
    g = h // hkv
    cq = _chunk(sq, accounting.chunk(chunk_q))
    ck = _chunk(sk, accounting.chunk(chunk_k))
    nq, nk = -(-sq // cq), -(-sk // ck)
    pad_q, pad_k = nq * cq - sq, nk * ck - sk
    if scale is None:
        scale = d ** -0.5
    tc = q.dtype if _tensor_core_einsums(q, k, v) else None
    work = tc or torch.float32

    def heads_first(x, s_pad, pad, per):
        # (b, s, hkv*per, e) -> (b*hkv, s_pad, per, e), zero tail rows
        x = torch.nn.functional.pad(x, (0, 0, 0, 0, 0, pad)) if pad else x
        e = x.shape[-1]
        return (x.reshape(b, s_pad, hkv, per, e).transpose(1, 2)
                .reshape(b * hkv, s_pad, per, e).to(work))

    qh = heads_first(q, nq * cq, pad_q, g)
    kh = heads_first(k, nk * ck, pad_k, 1)[:, :, 0]
    vh = heads_first(v, nk * ck, pad_k, 1)[:, :, 0]
    out = _Flash.apply(qh, kh, vh, causal, scale, cq, ck, sk, tc)
    out = (out.view(b, hkv, nq * cq, g, dv).transpose(1, 2)
           .reshape(b, nq * cq, h, dv))
    return out[:, :sq].to(q.dtype)


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


# ---------------------------------------------------------------------------
# MLA — DeepSeek-V2 Multi-head Latent Attention
# ---------------------------------------------------------------------------

class MLA(nn.Module):
    """MLA projections in the reference's (K, N) layout: `w_dkv` (d, r) and
    `w_kr` (d, dr) down to the cached latent and shared rotary key, `w_uk` /
    `w_uv` (r, h*dn) up from it, `wo` (h*dn, d); the query through `w_dq`
    (d, q_lora_rank) and `w_uq` when `q_lora_rank` is set, else `wq`."""

    def __init__(self, generator, cfg: ModelConfig, device="cuda"):
        super().__init__()
        device = resolve_device(device)
        d, h, r = cfg.d_model, cfg.n_heads, cfg.kv_lora_rank
        dn, dr = cfg.nope_head_dim, cfg.rope_head_dim

        def init(d_in, d_out):
            return dense_init(generator, d_in, d_out, cfg.dtype, device)

        self.w_dkv = init(d, r)
        self.w_kr = init(d, dr)
        self.w_uk = init(r, h * dn)
        self.w_uv = init(r, h * dn)
        self.wo = init(h * dn, d)
        if cfg.q_lora_rank:
            self.w_dq = init(d, cfg.q_lora_rank)
            self.w_uq = init(cfg.q_lora_rank, h * (dn + dr))
        else:
            self.wq = init(d, h * (dn + dr))


def mla_params(generator, cfg: ModelConfig, device="cuda") -> MLA:
    return MLA(generator, cfg, device)


def mla_attention(p: MLA, x: torch.Tensor, cfg: ModelConfig,
                  positions: torch.Tensor,
                  cache: Optional[Dict[str, object]] = None,
                  ) -> Tuple[torch.Tensor, Optional[Dict[str, object]]]:
    """MLA in the reference's two execution forms (DeepSeek-V2's own):

    - no cache (train, prefill): the NAIVE form — K and V up-projected from
      c_kv once, the one rotary key broadcast across the heads, attention at
      head dim dn + dr (`mla.sdpa`);
    - cache (decode): the ABSORBED form — W_uk folds into the query, so
      attention runs in latent space against the cached c_kv directly, an
      MQA with key width r + dr and value width r (`mla.decode`), and W_uv
      un-absorbs its output. Only c_kv and the rotary key are cached.

    The two absorption einsums are per-head batched contractions, which the
    reference computes outside any Pallas kernel: they stay `torch.einsum`
    and are recorded (count = heads) for the observed workload. As in
    `gqa_attention`, the step's latent and rotary key are written in place
    into the preallocated cache."""
    b, s, _ = x.shape
    dn, dr, h = cfg.nope_head_dim, cfg.rope_head_dim, cfg.n_heads
    r = cfg.kv_lora_rank

    if cfg.q_lora_rank:
        q = pmm(pmm(x, p.w_dq, tag="mla.q_down"), p.w_uq, tag="mla.q_up")
    else:
        q = pmm(x, p.wq, tag="mla.q")
    q = q.reshape(b, s, h, dn + dr)
    q_nope, q_rope = q[..., :dn], q[..., dn:]

    c_kv = pmm(x, p.w_dkv, tag="mla.kv_down")                   # (b, s, r)
    k_r = pmm(x, p.w_kr, tag="mla.k_rope").reshape(b, s, 1, dr)

    cos, sin = rope_tables(positions, dr, cfg.rope_theta)
    q_rope = apply_rope(q_rope, cos, sin)
    k_r = apply_rope(k_r, cos, sin)
    scale = (dn + dr) ** -0.5

    if cache is None:
        # naive form: up-project K/V once, attention at dim dn + dr
        k_nope = pmm(c_kv, p.w_uk, tag="mla.k_up").reshape(b, s, h, dn)
        v = pmm(c_kv, p.w_uv, tag="mla.v_up").reshape(b, s, h, dn)
        k_full = torch.cat([k_nope, k_r.expand(b, s, h, dr)], dim=-1)
        q_full = torch.cat([q_nope, q_rope], dim=-1)
        if s > 1024:
            unfused = lambda: chunked_sdpa(q_full, k_full, v, causal=True,
                                           scale=scale)
        else:
            unfused = lambda: _sdpa(q_full, k_full, v, causal=True,
                                    scale=scale)
        out = pattn(q_full, k_full, v, causal=True, scale=scale,
                    tag="mla.sdpa", unfused=unfused)
        return pmm(out.reshape(b, s, h * dn), p.wo, tag="mla.o"), None

    idx = int(cache["index"])
    cc, ckr = cache["c_kv"], cache["k_rope"]
    cc[:, idx:idx + s] = c_kv                        # in-place cache write
    ckr[:, idx:idx + s] = k_r
    new_cache = {"c_kv": cc, "k_rope": ckr, "index": idx + s}
    kv_len = torch.full((b,), idx + s, dtype=torch.int32, device=x.device)

    # absorbed form: q_lat[h] = q_nope[h] @ W_uk[h]^T, (b, s, h, r)
    record_gemm("mla.q_absorb", b * s, r, dn, count=h)
    q_lat = torch.einsum("bshd,rhd->bshr", q_nope, p.w_uk.reshape(r, h, dn))
    q_aug = torch.cat([q_lat, q_rope], dim=-1)              # (b, s, h, r+dr)
    k_aug = torch.cat([cc[:, :, None, :], ckr], dim=-1)     # (b, sk, 1, r+dr)
    v_lat = cc[:, :, None, :]                               # (b, sk, 1, r)
    o_lat = pattn(q_aug, k_aug, v_lat, causal=True, q_positions=positions,
                  kv_len=kv_len, scale=scale, tag="mla.decode",
                  unfused=lambda: _sdpa(q_aug, k_aug, v_lat, causal=True,
                                        q_positions=positions,
                                        kv_len=kv_len, scale=scale))
    # un-absorb the values: out[h] = o_lat[h] @ W_uv[h]
    record_gemm("mla.v_unabsorb", b * s, dn, r, count=h)
    out = torch.einsum("bshr,rhd->bshd", o_lat, p.w_uv.reshape(r, h, dn))
    return pmm(out.reshape(b, s, h * dn), p.wo, tag="mla.o"), new_cache


def make_kv_cache(cfg: ModelConfig, batch: int, max_len: int,
                  device="cuda") -> Dict[str, object]:
    """Preallocated per-layer cache and a host-side write index: K/V
    tensors, or for MLA the latent `c_kv` (batch, max_len, r) and the
    shared rotary key `k_rope` (batch, max_len, 1, dr)."""
    device = resolve_device(device)
    if cfg.attn == "mla":
        return {
            "c_kv": torch.zeros((batch, max_len, cfg.kv_lora_rank),
                                dtype=cfg.dtype, device=device),
            "k_rope": torch.zeros((batch, max_len, 1, cfg.rope_head_dim),
                                  dtype=cfg.dtype, device=device),
            "index": 0,
        }
    shape = (batch, max_len, cfg.n_kv_heads, cfg.hd)
    return {
        "k": torch.zeros(shape, dtype=cfg.dtype, device=device),
        "v": torch.zeros(shape, dtype=cfg.dtype, device=device),
        "index": 0,
    }
