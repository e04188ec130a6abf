"""Fused attention dataflow (FlatAttention): QKᵀ → online softmax → PV as
one tiled superstep sequence with per-composition collectives.

The unfused path runs attention as three independently-routed projection
GEMMs plus a stock softmax — the score matrix round-trips through memory
and the planner never sees the composition. FlatAttention (PAPERS.md) shows
MHA on tile-based many-PE accelerators wants its *own* dataflow: stream KV
tiles through L1, keep the online-softmax running stats (m, l) and the
output accumulator resident, and choose the collective per composition:

- **merge** — KV is sharded over the mesh's row axis; every device scans
  its local KV shard with the online-softmax recurrence, then one combine
  superstep reduces the partials across the row:
  ``m_g = pmax(m)``, ``l_g = psum(exp(m - m_g) * l)``,
  ``o_g = psum(exp(m - m_g) * acc)``, ``out = o_g / l_g``.
- **ring** — Q is additionally sharded over the row axis (sq blocks); the
  KV shards rotate around a `ppermute` ring so each device sees the full
  KV stream in dm supersteps, carrying (m, l, acc) through the scan.

Head sharding over the column axis is a lowering legality question
(`lower_attention`), not a tunable: query heads must divide the axis and
KV heads must divide too or be fully replicable (MQA / MLA-absorbed).

Layering mirrors `core/lower.py`: the planning half (`attn_candidates`,
`attn_tune`) is a copy of the reference's and needs no torch — the deploy
layer prices attention schedules with `sim.perf.estimate_attention` under
the same calibrated `CalibrationProfile` as GEMMs. `flat_attention` (the
executor `models.matmul.pattn` dispatches to) runs both compositions on
any mesh with the collectives of `core/collectives.py`; on the one-card
1x1 mesh they are identities, merge is the local masked softmax and ring
is one step of the online-softmax recurrence with no rotation.

Precision follows the reference on its chip. Its einsums are plain `jnp`
at DEFAULT precision: scores on the fp32 images of bf16 q and k, PV on
bf16 probabilities and bf16 v, fp32 out; a TPU runs them as bf16 passes.
So on the card bf16 (and fp16) operands take bf16 products with fp32
sums and fp32 out (`aten::bmm.dtype`; its backward, which aten does not
define, rounds the fp32 cotangent to the operand dtype as DEFAULT does).
CPU tensors keep the fp32 einsums the CPU parity tests compare.
"""
from __future__ import annotations

import functools
from typing import Optional, Tuple

from repro_torch.core.autotuner import TunedResult
from repro_torch.core.schedule import (ATTN_COMPOSITIONS, AttnSchedule, AttnShape,
                                 default_elem_dtype)
from repro_torch.hw.config import AcceleratorConfig
from repro_torch.sim.calibrate import is_trusted, ranking_cost
from repro_torch.sim.perf import estimate_attention

NEG_INF = -1e30

# KV-chunk menu, largest first (larger chunks amortize softmax passes and
# barriers; smaller ones fit the L1 working set) — same shape as the
# analytic shortlist's _TK_MENU.
_KV_CHUNK_MENU = (512, 256, 128, 64)


def _head_shard(shape: AttnShape, dn: int) -> bool:
    return (dn > 1 and shape.h % dn == 0
            and (shape.hkv % dn == 0 or shape.hkv == 1))


def attn_candidates(shape: AttnShape, hw: AcceleratorConfig,
                    elem_bytes: int = 4) -> Tuple[AttnSchedule, ...]:
    """Closed-form fused-attention candidates for `shape` on `hw`.

    The space is composition × kv_chunk — tiny, so the planner prices it
    inline (no bucketing, no background refinement). Only legal candidates
    are emitted: skv must shard over the row axis, ring additionally needs
    sq to (decode's sq=1 gets merge only), and the per-(batch, head) L1
    working set must fit the tile.
    """
    dm, dn = hw.grid
    if dm > 0 and shape.skv % dm:
        return ()
    kv_l = max(1, shape.skv // max(1, dm))
    head_shard = _head_shard(shape, dn)
    dtype = default_elem_dtype(elem_bytes, hw)
    comps = ["merge"]
    if dm > 1 and shape.sq % dm == 0:
        comps.append("ring")
    out, seen = [], set()
    for comp in comps:
        sq_l = shape.sq // dm if comp == "ring" else shape.sq
        for target in _KV_CHUNK_MENU:
            chunk = min(target, kv_l)
            if (comp, chunk) in seen:
                continue
            # working set per (batch, head): resident Q block + streamed
            # KV chunk + fp32 logits + fp32 (m, l, acc)
            ws = ((sq_l * shape.d + chunk * (shape.d + shape.dv)) * elem_bytes
                  + sq_l * chunk * 4 + sq_l * (2 + shape.dv) * 4)
            if ws > hw.tile.l1_bytes:
                continue
            seen.add((comp, chunk))
            out.append(AttnSchedule(shape=shape, composition=comp,
                                    kv_chunk=chunk, elem_bytes=elem_bytes,
                                    elem_dtype=dtype))
    return tuple(out)


def attn_tune(shape: AttnShape, hw: AcceleratorConfig, elem_bytes: int = 4,
              calibration=None) -> TunedResult:
    """Pick the best fused-attention schedule for `shape` on `hw`.

    Prices every candidate with `estimate_attention` and ranks by the same
    `ranking_cost` as the GEMM tuners: the calibrated prediction under a
    trusted `CalibrationProfile`, else the analytical prior. Raises
    `RuntimeError` when no fused candidate is legal (the planner treats
    that as an unresolvable shape, exactly like `analytic_tune`).
    """
    cands = attn_candidates(shape, hw, elem_bytes=elem_bytes)
    if not cands:
        raise RuntimeError(f"no legal flat-attention candidate for "
                           f"{shape.describe()} on {hw.name}")
    cost_fn = ranking_cost(calibration)
    best = None
    log = []
    for cand in cands:
        # cost_fn applies the trusted profile itself (profile.predict over
        # the analytical report) — same contract as price_candidates: the
        # stored report stays analytical, ranking provenance in `calibration`
        report = estimate_attention(cand, hw)
        cost = cost_fn(report)
        log.append((cand.describe(), cost, report.utilization(hw)))
        if best is None or cost < best[0]:
            best = (cost, cand, report)
    _, sched, report = best
    return TunedResult(schedule=sched, report=report,
                       candidates_tried=len(cands), log=log,
                       calibration=(calibration.digest()
                                    if is_trusted(calibration) else ""))


# -- execution ----------------------------------------------------------------

@functools.lru_cache(maxsize=None)
def _bmm_f32():
    """x @ y for (batch, m, k) x (batch, k, n) bf16 or fp16 CUDA operands:
    tensor-core products, fp32 sums and fp32 out, differentiable."""
    import torch

    def bmm(x, y):
        return torch.ops.aten.bmm.dtype(x, y, torch.float32)

    class BmmF32(torch.autograd.Function):
        @staticmethod
        def forward(ctx, x, y):
            ctx.save_for_backward(x, y)
            return bmm(x, y)

        @staticmethod
        def backward(ctx, g):
            x, y = ctx.saved_tensors
            g = g.to(x.dtype)
            dx = (bmm(g, y.mT).to(x.dtype) if ctx.needs_input_grad[0]
                  else None)
            dy = (bmm(x.mT, g).to(y.dtype) if ctx.needs_input_grad[1]
                  else None)
            return dx, dy

    return BmmF32.apply


def _tensor_core_einsums(q, k, v) -> bool:
    """Whether the einsums take bf16 products on the card: CUDA operands of
    one 16-bit float dtype."""
    import torch
    return (q.is_cuda and q.dtype in (torch.bfloat16, torch.float16)
            and k.dtype == q.dtype and v.dtype == q.dtype)


def flat_attention(q, k, v, mesh, exec_plan, *, causal: bool = True,
                   scale: Optional[float] = None, q_positions=None,
                   kv_len=None):
    """Execute fused attention on `mesh` under a lowered `ExecPlan`.

    q: (b, sq, h, d); k: (b, skv, hkv, d); v: (b, skv, hkv, dv) ->
    (b, sq, h, dv), whole on every rank. GQA grouping (h a multiple of hkv)
    is handled by reshaping q to (..., hkv, g, d); `q_positions` (sq,) and
    `kv_len` (b,) carry decode's absolute positions and valid-cache
    lengths, with the same mask semantics as `models.attention._sdpa`.

    KV is sharded over the row axis, each rank's positions offset by its
    row index; heads are sharded over the column axis when the plan says
    `head_shard`. Merge combines the row's partials with `pmax` and `psum`;
    ring also shards Q over the row axis and rotates the KV shards around
    a `ppermute` ring, carrying the online softmax's (m, l, acc). At one
    row (dm == 1) the ring is its single step, where the reference runs
    the merge body: the same value, normalised after PV instead of
    before."""
    import torch
    from repro_torch.core.collectives import (axis_index, pmax, ppermute,
                                              psum, shard, unshard)

    row = exec_plan.axes["row"]
    col = exec_plan.axes["col"]
    comp = exec_plan.kwargs.get("composition", "merge")
    head_shard = bool(exec_plan.kwargs.get("head_shard", False))
    dm = int(mesh.shape[row])
    dn = int(mesh.shape[col])

    b, sq, h, d = q.shape
    skv, hkv = k.shape[1], k.shape[2]
    dv = v.shape[-1]
    if scale is None:
        scale = d ** -0.5
    h_l = h // dn if head_shard else h
    hkv_shard = head_shard and hkv % dn == 0 and hkv > 1
    hkv_l = hkv // dn if hkv_shard else hkv
    g = h_l // hkv_l
    kv_l = skv // dm
    ring = comp == "ring"
    sq_l = sq // dm if ring else sq
    dev = q.device
    qpos = (q_positions if q_positions is not None
            else torch.arange(sq, device=dev))
    klen = (kv_len if kv_len is not None
            else torch.full((b,), skv, dtype=torch.int32, device=dev))
    hq_spec = col if head_shard else None
    hkv_spec = col if hkv_shard else None
    kv_spec = (None, row, hkv_spec, None)
    q_spec = (None, row if ring else None, hq_spec, None)
    ri = axis_index(mesh, row)
    tc = _tensor_core_einsums(q, k, v)

    def scores(q_l, k_c):
        # (b, sq_l, hkv_l, g, d) x (b, ck, hkv_l, d) -> (b, hkv_l, g, sq_l, ck)
        ck = k_c.shape[1]
        qg = q_l.reshape(b, sq_l, hkv_l, g, d)
        if tc:
            x = qg.permute(0, 2, 3, 1, 4).reshape(b * hkv_l, g * sq_l, d)
            y = k_c.permute(0, 2, 3, 1).reshape(b * hkv_l, d, ck)
            s_ = _bmm_f32()(x, y).view(b, hkv_l, g, sq_l, ck)
        else:
            s_ = torch.einsum("bqhgd,bkhd->bhgqk", qg.float(), k_c.float())
        return s_ * scale

    def pv(p, v_c):
        # p at the value dtype x (b, ck, hkv_l, dv) -> (b, hkv_l, g, sq_l, dv)
        ck = v_c.shape[1]
        p = p.to(v_c.dtype)
        if tc:
            x = p.reshape(b * hkv_l, g * sq_l, ck)
            y = v_c.permute(0, 2, 1, 3).reshape(b * hkv_l, ck, dv)
            return _bmm_f32()(x, y).view(b, hkv_l, g, sq_l, dv)
        return torch.einsum("bhgqk,bkhd->bhgqd", p.float(), v_c.float())

    def masked(logits, kpos, qp):
        if causal:
            mask = kpos[None, :] <= qp[:, None]
            logits = logits.masked_fill(~mask[None, None, None], NEG_INF)
        valid = kpos[None, :] < klen[:, None]
        return logits.masked_fill(~valid[:, None, None, None], NEG_INF)

    q_l = shard(q, mesh, q_spec)
    k_c = shard(k, mesh, kv_spec)
    v_c = shard(v, mesh, kv_spec)
    if ring:
        qp = qpos[ri * sq_l:(ri + 1) * sq_l]
        m_run = torch.full((b, hkv_l, g, sq_l), NEG_INF, dtype=torch.float32,
                           device=dev)
        l_run = torch.zeros_like(m_run)
        acc = torch.zeros((*m_run.shape, dv), dtype=torch.float32, device=dev)
        perm = [(j, (j + 1) % dm) for j in range(dm)]
        for t in range(dm):
            # at step t this rank holds the shard ring-shifted from source
            # (ri - t) mod dm, whose global KV offset anchors the masks
            src = (ri - t) % dm
            kpos = src * kv_l + torch.arange(kv_l, device=dev)
            logits = masked(scores(q_l, k_c), kpos, qp)
            m_new = torch.maximum(m_run, logits.amax(dim=-1).detach())
            p = torch.exp(logits - m_new[..., None])
            corr = torch.exp(m_run - m_new)
            l_run = l_run * corr + p.sum(dim=-1)
            acc = acc * corr[..., None] + pv(p, v_c)
            m_run = m_new
            if t < dm - 1:             # the last rotation is never read
                k_c = ppermute(k_c, mesh, row, perm)
                v_c = ppermute(v_c, mesh, row, perm)
        out = acc / torch.clamp(l_run, min=1e-30)[..., None]
    else:
        kpos = ri * kv_l + torch.arange(kv_l, device=dev)
        logits = masked(scores(q_l, k_c), kpos, qpos)
        m_g = pmax(logits.amax(dim=-1), mesh, row)
        p = torch.exp(logits - m_g[..., None])
        l_g = psum(p.sum(dim=-1), mesh, row)
        # normalize BEFORE PV (l_g is already global) and multiply at the
        # value dtype — the same normalize-then-cast rounding as _sdpa's
        probs = p / torch.clamp(l_g, min=1e-30)[..., None]
        out = psum(pv(probs, v_c), mesh, row)
    out = out.permute(0, 3, 1, 2, 4).reshape(b, sq_l, h_l, dv).to(q.dtype)
    return unshard(out, mesh, q_spec, (b, sq, h, dv))
