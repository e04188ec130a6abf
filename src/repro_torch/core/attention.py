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
executor `models.matmul.pattn` dispatches to) is ported for a mesh whose
axes have size 1: merge is the local masked softmax, ring is one step of
the online-softmax recurrence with no rotation; a larger mesh raises until
the `torch.distributed` slice.
"""
from __future__ import annotations

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

def flat_attention(q, k, v, mesh, exec_plan, *, causal: bool = True,
                   scale: Optional[float] = None, q_positions=None,
                   kv_len=None):
    """Execute fused attention on `mesh` under a lowered `ExecPlan`.

    q: (b, sq, h, d); k: (b, skv, hkv, d); v: (b, skv, hkv, dv) ->
    (b, sq, h, dv). GQA grouping (h a multiple of hkv) is handled by
    reshaping q to (..., hkv, g, d); `q_positions` (sq,) and `kv_len` (b,)
    carry decode's absolute positions and valid-cache lengths, with the
    same mask semantics as `models.attention._sdpa`. On one rank the merge
    composition's pmax/psum combine and the ring's rotation are identities.
    """
    import torch

    row = exec_plan.axes["row"]
    col = exec_plan.axes["col"]
    comp = exec_plan.kwargs.get("composition", "merge")
    dm = int(mesh.shape[row])
    dn = int(mesh.shape[col])
    if dm * dn != 1:
        raise NotImplementedError(
            f"flat_attention on a {dm}x{dn} mesh needs multi-rank "
            f"collectives: the torch.distributed slice of the port is not "
            f"written yet (ROADMAP.md, queue 1)")

    b, sq, h, d = q.shape
    skv, hkv = k.shape[1], k.shape[2]
    dv = v.shape[-1]
    if scale is None:
        scale = d ** -0.5
    g = h // hkv
    dev = q.device
    qpos = (q_positions if q_positions is not None
            else torch.arange(sq, device=dev))
    klen = (kv_len if kv_len is not None
            else torch.full((b,), skv, dtype=torch.int32, device=dev))
    kpos = torch.arange(skv, device=dev)          # the one rank's KV shard

    qg = q.reshape(b, sq, hkv, g, d).float()
    logits = torch.einsum("bqhgd,bkhd->bhgqk", qg, k.float()) * scale
    if causal:
        mask = kpos[None, :] <= qpos[:, None]
        logits = logits.masked_fill(~mask[None, None, None], NEG_INF)
    valid = kpos[None, :] < klen[:, None]
    logits = logits.masked_fill(~valid[:, None, None, None], NEG_INF)

    if comp == "ring":
        # the ring's online-softmax recurrence over its dm == 1 step: the
        # local KV shard, no rotation; K/V stay at the operand dtype and PV
        # matches _sdpa's probs-cast rounding
        m_run = torch.full(logits.shape[:-1], NEG_INF, dtype=torch.float32,
                           device=dev)
        l_run = torch.zeros_like(m_run)
        acc = torch.zeros((*m_run.shape, dv), dtype=torch.float32, device=dev)
        for _ in range(dm):
            m_new = torch.maximum(m_run, logits.amax(dim=-1).detach())
            p = torch.exp(logits - m_new[..., None])
            corr = torch.exp(m_run - m_new)
            l_run = l_run * corr + p.sum(dim=-1)
            acc = acc * corr[..., None] + torch.einsum(
                "bhgqk,bkhd->bhgqd", p.to(v.dtype).float(), v.float())
            m_run = m_new
        out = acc / torch.clamp(l_run, min=1e-30)[..., None]
    else:
        m_g = logits.amax(dim=-1).detach()
        p = torch.exp(logits - m_g[..., None])
        l_g = p.sum(dim=-1)
        # normalize BEFORE PV and multiply at the value dtype — the same
        # normalize-then-cast rounding as _sdpa's softmax
        probs = p / torch.clamp(l_g, min=1e-30)[..., None]
        out = torch.einsum("bhgqk,bkhd->bhgqd",
                           probs.to(v.dtype).float(), v.float())
    out = out.permute(0, 3, 1, 2, 4).reshape(b, sq, h, dv)
    return out.to(q.dtype)
