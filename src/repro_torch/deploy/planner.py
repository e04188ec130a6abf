"""Planner: the deployment front-end over the autotuner.

One `Planner` owns (hardware, cache, search knobs) and answers every "how do
I run this GEMM" question a serving stack asks:

- `plan(shape)` — the dispatch path. Exact cache hit returns instantly (no
  candidate enumeration); a miss first tries a bucketed transfer from a
  nearby tuned shape (one build + one estimate instead of a full search, and
  the exact shape is queued for background refinement); only a cold shape
  with no usable neighbour pays a full `tune`.
- `plan_cached(shape)` — the serving path: hit, else bucketed transfer,
  else an *online* tune over the closed-form analytic shortlist
  (core/analytic.py — bounded candidate count, recorded as an `analytic`
  plan and queued for background refinement). A cold shape never pays the
  full candidate search at trace time.
- `batch_tune(shapes)` — warm the cache for a whole workload in one pass,
  deduping shapes first.
- `refine_pending()` / `refine_async(executor)` — the background-refinement
  hook: re-tune bucket- and analytic-served shapes for real and upgrade
  their cache entries when the fresh schedule is no worse.

`model_workload` extracts the deduplicated GEMM shapes of one model
config's forward pass (projections, FFN, MoE experts, LM head) so a server
can warm its planner from the architectures it will host.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict, List, Optional, Sequence, Tuple

from repro_torch.core.analytic import DEFAULT_SHORTLIST_K, analytic_tune
from repro_torch.core.attention import attn_tune
from repro_torch.core.autotuner import tune
from repro_torch.core.schedule import AttnShape, GEMMShape, build_program
from repro_torch.hw.config import AcceleratorConfig
from repro_torch.obs.trace import maybe_span
from repro_torch.sim.perf import estimate

from repro_torch.deploy.bucketing import BucketingPolicy, transfer_candidates, adapt
from repro_torch.deploy.cache import PlanCache
from repro_torch.deploy.plan import (DeploymentPlan, SOURCE_ANALYTIC,
                               SOURCE_BUCKETED, SOURCE_TUNED,
                               hw_fingerprint, plan_admissible,
                               plan_from_tuning, search_variant)


class Planner:
    def __init__(self, hw: AcceleratorConfig,
                 cache: Optional[PlanCache] = None,
                 elem_bytes: Optional[int] = None,
                 max_candidates: int = 48,
                 dataflows: Optional[List[str]] = None,
                 store_stage_options: Tuple[int, ...] = (1, 4),
                 policy: BucketingPolicy = BucketingPolicy(),
                 on_plan: Optional[Callable[[DeploymentPlan], None]] = None,
                 calibration=None,
                 online_tune: bool = True,
                 analytic_k: int = DEFAULT_SHORTLIST_K):
        self.hw = hw
        self.cache = cache if cache is not None else PlanCache()
        self.elem_bytes = (elem_bytes if elem_bytes is not None
                           else hw.tile.elem_bytes)
        self.max_candidates = max_candidates
        # [] would mean 'unrestricted' to the tuner but 'nothing admissible'
        # to the cache check — normalize it to None so both agree.
        self.dataflows = list(dataflows) if dataflows else None
        self.store_stage_options = store_stage_options
        self.policy = policy
        self.on_plan = on_plan
        # measured-calibration profile (sim/calibrate.CalibrationProfile):
        # every tune this planner runs ranks candidates by the calibrated
        # cost, and a trusted profile widens the DEFAULT search space. A
        # profile fitted for different hardware is refused outright — a
        # mis-keyed profile must not silently re-rank another machine.
        if calibration is not None \
                and calibration.hw_digest != hw_fingerprint(hw):
            raise ValueError(
                f"calibration profile {calibration.describe()} was fitted "
                f"for hw digest {calibration.hw_digest}, not "
                f"{hw_fingerprint(hw)} ({hw.name})")
        self.calibration = calibration
        # the ranking regime this planner serves plans under: a trusted
        # profile's digest, else "" (analytical prior — an UNTRUSTED profile
        # changes nothing, so it shares the prior's regime). Cached plans
        # ranked under a different regime are re-tuned, not served: without
        # this, a warmed cache dir would make a later calibration a silent
        # no-op for every already-cached shape.
        self._calibration_digest = (calibration.digest()
                                    if calibration is not None
                                    and calibration.fit_ok else "")
        # restricted searches live under their own cache-key variant so they
        # never collide with (or clobber) the unrestricted winners.
        self.variant = search_variant(dataflows)
        # online (analytic) tuning of plan_cached misses: price the
        # closed-form shortlist instead of returning None. `analytic_k`
        # bounds the per-miss work.
        self.online_tune = online_tune
        self.analytic_k = analytic_k
        self._pending: List[GEMMShape] = []

    # -- dispatch path ------------------------------------------------------

    def plan(self, shape: GEMMShape,
             allow_bucketed: bool = True) -> DeploymentPlan:
        cached = self.cache.get(shape, self.elem_bytes, self.hw,
                                self.variant)
        if cached is not None and self._admissible(cached) \
                and cached.source != SOURCE_ANALYTIC:
            # an analytic entry (online shortlist winner) is served on the
            # dispatch path but never satisfies `plan`: here paying the full
            # search is the point, and the fresh tune replaces the entry.
            return cached
        if isinstance(shape, AttnShape):
            # the fused-attention candidate space IS the closed-form menu —
            # there is no bigger search to pay, so the warm-up path caches
            # the same winner as SOURCE_TUNED (it satisfies `plan` on
            # re-lookup and never needs refinement)
            plan = self._attn_plan(shape, source=SOURCE_TUNED)
            if plan is None:
                raise RuntimeError(f"no legal flat-attention candidate for "
                                   f"{shape.describe()} on {self.hw.name}")
            return plan
        if allow_bucketed:
            bucketed = self._bucketed_plan(shape)
            if bucketed is not None:
                return bucketed
        return self._tune_and_cache(shape)

    def plan_cached(self, shape: GEMMShape) -> Optional[DeploymentPlan]:
        """`plan` minus the full tune — the serving dispatch path.

        Exact cache hit, else a bucketed transfer, else an online tune over
        the closed-form analytic shortlist (both of which queue the shape
        for background refinement), else None. A cold shape never pays the
        full candidate search at trace time; when even the analytic path
        finds no legal candidate the caller (`models.matmul.pmm`) falls
        back to the auto dataflow and counts the miss.
        """
        cached = self.cache.get(shape, self.elem_bytes, self.hw,
                                self.variant)
        if cached is not None and self._admissible(cached):
            return cached
        bucketed = self._bucketed_plan(shape)
        if bucketed is not None:
            return bucketed
        return self._analytic_plan(shape)

    def _admissible(self, plan) -> bool:
        """Defensive check on top of the variant keying — the shared rule
        lives in `deploy.plan.plan_admissible` (tune_cached applies the
        same one)."""
        return plan_admissible(plan, self.dataflows,
                               self._calibration_digest)

    def _cost(self, report) -> float:
        """The ranking cost this planner compares plans by: the trusted
        profile's calibrated prediction, else the analytical total."""
        if self._calibration_digest:
            return self.calibration.predict(report)
        return report.total_time

    def _bucketed_plan(self, shape: GEMMShape) -> Optional[DeploymentPlan]:
        if isinstance(shape, AttnShape):
            # attention plans never transfer between shapes: legality is
            # all-or-nothing divisibility, and the candidate menu is cheap
            # enough to price exactly per shape
            return None
        pool = list(self.cache.shapes_for(self.elem_bytes, self.hw,
                                          self.variant))
        best = None     # (time, schedule, report)
        priced = 0
        for src_shape in transfer_candidates(shape, pool, self.policy):
            if priced >= self.policy.max_transfers:
                break
            src = self.cache.peek(src_shape, self.elem_bytes, self.hw,
                                  self.variant)
            if src is None or not self._admissible(src):
                continue
            if src.source != SOURCE_TUNED:
                # never seed transfers from anything but a full tune.
                # Bucketed sources would compound the per-hop tolerance
                # loss unboundedly (each hop can lose up to `tolerance`
                # and the expected-time guard scales the *source's* time);
                # analytic sources are unrefined shortlist winners — the
                # full search never validated them, so adapting one would
                # chain a second unvalidated approximation onto the first.
                continue
            adapted = adapt(src.schedule, shape, self.hw)
            if adapted is None:
                continue
            try:
                report = estimate(build_program(adapted, self.hw), self.hw)
            except (ValueError, KeyError):
                continue
            priced += 1
            # what this shape *should* cost if the transfer preserved the
            # source's efficiency: the source's time scaled by the work
            # ratio (compute- and memory-bound lower bounds).
            scale = max(shape.flops() / src_shape.flops(),
                        shape.min_bytes(self.elem_bytes)
                        / src_shape.min_bytes(self.elem_bytes))
            expected = src.report.total_time * scale
            if report.total_time > (1.0 + self.policy.tolerance) * expected:
                # this transfer lost too much efficiency (e.g. the tuned
                # grid's tiles no longer fill the engine) — but another
                # source may still pass its own bound, so keep looking.
                continue
            # rank surviving transfers by the planner's ranking cost (the
            # tolerance guard above stays analytical: it compares the
            # analytical estimate against an analytically-scaled bound)
            if best is None or self._cost(report) < best[0]:
                best = (self._cost(report), adapted, report)
        if best is None:
            return None
        plan = plan_from_tuning(shape, self.hw, best[1], best[2],
                                source=SOURCE_BUCKETED,
                                variant=self.variant,
                                calibration_digest=self._calibration_digest)
        self.cache.put(plan)
        self._pending.append(shape)
        self._emit(plan)
        return plan

    def _analytic_plan(self, shape: GEMMShape) -> Optional[DeploymentPlan]:
        """Online tune: price the closed-form shortlist for a cold shape.

        Bounded work (`analytic_k` candidates instead of the full
        enumeration), so the serving path can afford it on a miss. The
        winner is cached as an `analytic` plan — served like any other,
        but queued for background refinement, never a transfer source, and
        replaced outright the first time `plan` sees the shape.
        """
        if not self.online_tune:
            return None
        if isinstance(shape, AttnShape):
            return self._attn_plan(shape)
        with maybe_span("planner.online_tune", m=shape.m, n=shape.n,
                        k=shape.k) as span_args:
            try:
                res = analytic_tune(shape, self.hw, dataflows=self.dataflows,
                                    elem_bytes=self.elem_bytes,
                                    k=self.analytic_k,
                                    store_stage_options=self.store_stage_options,
                                    calibration=self.calibration)
            except RuntimeError:
                # no legal shortlist candidate — the caller counts the miss
                if span_args is not None:
                    span_args["resolved"] = False
                return None
            if span_args is not None:
                span_args.update(resolved=True,
                                 candidates=res.candidates_tried,
                                 schedule=res.schedule.describe())
        plan = plan_from_tuning(shape, self.hw, res.schedule, res.report,
                                candidates_tried=res.candidates_tried,
                                source=SOURCE_ANALYTIC, variant=self.variant,
                                calibration_digest=res.calibration)
        self.cache.put(plan)
        self._pending.append(shape)
        self._emit(plan)
        return plan

    def _attn_plan(self, shape: AttnShape,
                   source: str = SOURCE_ANALYTIC) -> Optional[DeploymentPlan]:
        """Resolve a fused-attention shape through the closed-form candidate
        menu (core/attention.attn_tune — composition × kv_chunk, priced by
        `sim.perf.estimate_attention` under the planner's calibration).

        The space is tiny, so the same bounded pricing serves both the
        serving path (`plan_cached` → SOURCE_ANALYTIC) and the warm-up path
        (`plan` → SOURCE_TUNED). Never queued for refinement — there is no
        fuller search to validate against. Returns None when no fused
        candidate is legal (the pattn funnel falls back to the unfused
        path and counts the miss).
        """
        with maybe_span("planner.online_tune", attn=shape.describe(),
                        sq=shape.sq, skv=shape.skv, h=shape.h) as span_args:
            try:
                res = attn_tune(shape, self.hw, elem_bytes=self.elem_bytes,
                                calibration=self.calibration)
            except RuntimeError:
                if span_args is not None:
                    span_args["resolved"] = False
                return None
            if span_args is not None:
                span_args.update(resolved=True,
                                 candidates=res.candidates_tried,
                                 schedule=res.schedule.describe())
        plan = plan_from_tuning(shape, self.hw, res.schedule, res.report,
                                candidates_tried=res.candidates_tried,
                                source=source, variant=self.variant,
                                calibration_digest=res.calibration)
        self.cache.put(plan)
        self._emit(plan)
        return plan

    def _tune_and_cache(self, shape: GEMMShape) -> DeploymentPlan:
        plan = self._tune_shape(shape)
        self.cache.put(plan)
        self._emit(plan)
        return plan

    def _emit(self, plan: DeploymentPlan) -> None:
        if self.on_plan is not None:
            self.on_plan(plan)

    # -- batch warming ------------------------------------------------------

    def batch_tune(self, shapes: Sequence[GEMMShape],
                   allow_bucketed: bool = False,
                   skip_illegal: bool = False
                   ) -> Dict[GEMMShape, DeploymentPlan]:
        """Tune a whole workload's (deduplicated) shapes into the cache.

        `skip_illegal` swallows per-shape "no legal schedule" errors —
        a dataflow-restricted planner (e.g. a Fig. 6c-only search) may have
        shapes with no legal candidate at all; those stay unplanned and the
        dispatch path counts them as fallbacks instead of aborting the warm.
        """
        out: Dict[GEMMShape, DeploymentPlan] = {}
        for shape in dict.fromkeys(shapes):
            try:
                out[shape] = self.plan(shape, allow_bucketed=allow_bucketed)
            except RuntimeError:
                if not skip_illegal:
                    raise
        return out

    # -- background refinement ---------------------------------------------

    @property
    def pending_refinements(self) -> Tuple[GEMMShape, ...]:
        return tuple(self._pending)

    def refine_pending(self, limit: Optional[int] = None
                       ) -> List[Tuple[GEMMShape, float, float]]:
        """Full-tune bucket-served shapes; upgrade entries that improve.

        Returns (shape, bucketed_cost, tuned_cost) per refinement — the
        validation record of the bucketing shortcut. Costs are the
        planner's ranking costs (calibrated when a trusted profile is
        installed), so refinement never un-picks a calibrated winner for
        looking worse under the analytical prior.
        """
        n = len(self._pending) if limit is None else min(limit,
                                                         len(self._pending))
        todo, self._pending = self._pending[:n], self._pending[n:]
        out = []
        for shape in todo:
            out.append(self._refine_one(shape))
        return out

    def refine_async(self, executor) -> List["object"]:
        """Submit pending refinements to a concurrent.futures executor."""
        todo, self._pending = self._pending, []
        return [executor.submit(self._refine_one, shape) for shape in todo]

    def _refine_one(self, shape: GEMMShape
                    ) -> Tuple[GEMMShape, float, float]:
        current = self.cache.peek(shape, self.elem_bytes, self.hw,
                                  self.variant)
        fresh = self._tune_shape(shape)
        old_t = self._cost(current.report) if current else float("inf")
        # <= so a tie still records the validation: the entry becomes
        # SOURCE_TUNED and can seed future transfers.
        if self._cost(fresh.report) <= old_t:
            self.cache.put(fresh)
            self._emit(fresh)
        elif current is not None and current.source == SOURCE_ANALYTIC:
            # the shortlist winner beat the (bounded) full search — the
            # search still validated it, so upgrade its provenance: it may
            # now seed transfers and satisfies `plan` like any tuned entry.
            upgraded = dataclasses.replace(current, source=SOURCE_TUNED)
            self.cache.put(upgraded)
            self._emit(upgraded)
        return (shape, old_t, self._cost(fresh.report))

    def _tune_shape(self, shape: GEMMShape) -> DeploymentPlan:
        res = tune(shape, self.hw, dataflows=self.dataflows,
                   elem_bytes=self.elem_bytes,
                   max_candidates=self.max_candidates,
                   store_stage_options=self.store_stage_options,
                   calibration=self.calibration)
        return plan_from_tuning(shape, self.hw, res.schedule, res.report,
                                candidates_tried=res.candidates_tried,
                                source=SOURCE_TUNED, variant=self.variant,
                                calibration_digest=res.calibration)

    # -- validation ---------------------------------------------------------

    def transfer_ratio(self, shape: GEMMShape) -> float:
        """estimated(bucketed plan) / estimated(fresh tune) for `shape`.

        Used by tests and the cold/warm benchmark to check the bucketing
        tolerance; runs a full tune, so it is NOT a dispatch-path call.
        """
        plan = self.plan(shape)
        fresh = self._tune_shape(shape)
        return plan.report.total_time / fresh.report.total_time


# ---------------------------------------------------------------------------
# Workload extraction
# ---------------------------------------------------------------------------

def moe_dispatch_geometry(tokens: int, cfg, dp: int = 1) -> Tuple[int, int]:
    """(dispatch groups, per-group expert capacity) for `tokens` tokens.

    Pure-int mirror of `repro_torch.models.moe._dp_groups` / `_capacity` (the
    deploy layer must stay importable without jax, so the logic is duplicated
    here; tests/test_plan_routing.py pins the two in sync by comparing this
    prediction against the shapes moe.apply_moe actually records). `dp` is
    the data-parallel shard count the dispatch groups align to (1 when no
    mesh is installed).
    """
    group_tokens = 512                      # moe._GROUP_TOKENS
    if tokens % dp:
        dp = 1
    g = dp
    while tokens % (g * 2) == 0 and tokens // (g * 2) >= group_tokens:
        g *= 2
    tl = tokens // g
    cap = max(int(tl * cfg.moe_top_k * cfg.capacity_factor / cfg.n_experts), 4)
    return g, cap


def model_workload(cfg, batch: int, seq: int,
                   kind: str = "prefill", dp: int = 1) -> List[GEMMShape]:
    """Deduplicated projection GEMMs of one forward pass of `cfg`.

    `cfg` is a `repro_torch.models.common.ModelConfig` (duck-typed so the deploy
    layer stays importable without jax). Token dimension M is batch*seq for
    train/prefill and batch for decode; weights supply (K, N). `dp` is the
    data-parallel shard count of the mesh the model will trace under (1
    when no mesh is installed) — it feeds the MoE dispatch-group geometry,
    which aligns groups to the DP axes.

    These are the shapes the model stack actually traces through
    `models.matmul.pmm` — every entry is checked against the recorded
    (tag, GEMMShape) pairs of a real forward pass in
    tests/test_plan_routing.py, so launcher warm-ups tune exactly the GEMMs
    that will be dispatched — including the encoder-decoder stacks
    (encoder self-attention blocks over the frame prefix, and the decoder
    cross-attention K/V projections that re-run over the encoder output on
    every decode step).
    """
    tokens = batch * seq if kind in ("train", "prefill") else batch
    tokens = max(1, tokens)
    d, hd = cfg.d_model, cfg.hd
    pattern = getattr(cfg, "block_pattern", "attn")
    shapes: List[GEMMShape] = []

    def gemm(m, n, k):
        if m > 0 and n > 0 and k > 0:
            shapes.append(GEMMShape(m, n, k))

    # modality frontend stub: the learned (d x d) projection applied to the
    # precomputed patch/frame embeddings (models.model.forward tags it
    # frontend.proj). Decode steps never re-run the frontend. For the VLM
    # frontends the projected prefix is prepended to the token sequence, so
    # every downstream block GEMM runs at batch*(n_prefix + seq) rows.
    front = getattr(cfg, "frontend", "none")
    n_prefix = getattr(cfg, "n_prefix", 0)
    if front in ("vision_stub", "audio_stub") and n_prefix \
            and kind in ("train", "prefill"):
        gemm(batch * n_prefix, d, d)                    # frontend.proj
        if not getattr(cfg, "is_encoder_decoder", False):
            tokens += batch * n_prefix                  # prefix joins the seq

    # attention projections (xlstm stacks have no attention blocks)
    if pattern == "xlstm":
        d_inner = 2 * d
        gemm(tokens, 2 * d_inner, d)                    # mLSTM up
        gemm(tokens, d_inner, d_inner)                  # q / k / v (identical)
        gemm(tokens, 2 * cfg.n_heads, d)                # i/f gate pre-acts
        gemm(tokens, d, d_inner)                        # mLSTM down
        gemm(tokens, 4 * d, d)                          # sLSTM in
        gemm(tokens, d, d)                              # sLSTM out
    elif getattr(cfg, "attn", "gqa") == "mla":
        if cfg.q_lora_rank:
            gemm(tokens, cfg.q_lora_rank, d)
        qdim = cfg.n_heads * (cfg.nope_head_dim + cfg.rope_head_dim)
        gemm(tokens, qdim, cfg.q_lora_rank or d)
        # the model runs the KV down-projection and the shared rotary key as
        # two separate matmuls (attention.mla_attention), not one fused GEMM
        gemm(tokens, cfg.kv_lora_rank, d)
        gemm(tokens, cfg.rope_head_dim, d)
        if kind == "decode":
            # absorbed form: W_uk folds into the query and W_uv un-absorbs
            # the latent output — n_heads per-head (r x dn) contractions
            # each, no K/V up-projection ever runs. The shape list is a
            # set (coverage is membership-based); the per-head multiplicity
            # lives in the observed counts: attention.mla_attention records
            # these two with count=n_heads per call.
            gemm(tokens, cfg.kv_lora_rank, cfg.nope_head_dim)
            gemm(tokens, cfg.nope_head_dim, cfg.kv_lora_rank)
        else:
            # naive form: up-project K and V (identical shapes) from c_kv
            gemm(tokens, cfg.n_heads * cfg.nope_head_dim, cfg.kv_lora_rank)
        gemm(tokens, d, cfg.n_heads * cfg.nope_head_dim)
    else:
        gemm(tokens, cfg.n_heads * hd, d)               # Q
        gemm(tokens, cfg.n_kv_heads * hd, d)            # K and V (identical)
        gemm(tokens, d, cfg.n_heads * hd)               # O
    # encoder-decoder stacks (seamless): the encoder runs full
    # self-attention blocks over the frame prefix, and every decoder layer
    # adds cross-attention whose Q/O run at decoder rows (identical to the
    # self-attention shapes above) while K/V project the ENCODER output —
    # and therefore re-run at encoder rows on every decode step too.
    if getattr(cfg, "is_encoder_decoder", False):
        enc_tokens = batch * n_prefix
        if enc_tokens:
            if kind in ("train", "prefill"):
                # encoder self-attention blocks (prefill/train only; decode
                # consumes the precomputed encoder output)
                gemm(enc_tokens, cfg.n_heads * hd, d)       # enc Q
                gemm(enc_tokens, cfg.n_kv_heads * hd, d)    # enc K and V
                gemm(enc_tokens, d, cfg.n_heads * hd)       # enc O
                if cfg.d_ff:
                    gemm(enc_tokens, cfg.d_ff, d)           # enc gate / up
                    gemm(enc_tokens, d, cfg.d_ff)           # enc down
            # decoder cross-attention K/V over the encoder output (every
            # kind — decode recomputes them each step, attention.py has no
            # cross-attention cache)
            gemm(enc_tokens, cfg.n_kv_heads * hd, d)
    # SSM mixer projections of the hybrid stacks (zamba2); the shared
    # attention block above supplies the attn/FFN shapes
    if pattern == "mamba2_hybrid":
        d_inner = 2 * d
        nh = d_inner // cfg.mamba_headdim
        gemm(tokens, 2 * d_inner + 2 * cfg.ssm_state + nh, d)   # fused in
        gemm(tokens, d, d_inner)                                # out
    # FFN (dense layers) and MoE experts
    if cfg.d_ff and pattern != "xlstm":
        gemm(tokens, cfg.d_ff, d)                       # gate / up (identical)
        gemm(tokens, d, cfg.d_ff)                       # down
    if cfg.n_experts and cfg.moe_top_k:
        # per-expert M is the capacity-bounded dispatch buffer, not the mean
        # token count: each (group, expert) GEMM runs at exactly `cap` rows
        _, cap = moe_dispatch_geometry(tokens, cfg, dp=dp)
        gemm(tokens, cfg.n_experts, d)                  # router
        gemm(cap, cfg.moe_d_ff, d)                      # expert gate / up
        gemm(cap, d, cfg.moe_d_ff)                      # expert down
        if getattr(cfg, "n_shared_experts", 0):
            sh_ff = cfg.moe_d_ff * cfg.n_shared_experts
            gemm(tokens, sh_ff, d)
            gemm(tokens, d, sh_ff)
    # LM head
    gemm(tokens, cfg.vocab, d)
    return list(dict.fromkeys(shapes))


def workload_coverage(predicted: Sequence[GEMMShape],
                      observed: Sequence[GEMMShape]) -> Dict[str, object]:
    """Cross-validate `model_workload` against what the model actually ran.

    `observed` is the deduplicated shape list a `GemmContext` recorded
    (`stats.observed_shapes()`). Returns the predicted shapes that never
    executed (`missing` — warm-up tuned something useless), the executed
    shapes the prediction did not cover (`extra` — warm-up skipped real
    traffic), and the covered fraction of the observed workload.
    """
    pred, obs = set(predicted), set(observed)
    covered = len(obs & pred) / len(obs) if obs else 1.0
    return {
        "missing": sorted(pred - obs, key=lambda s: (s.m, s.n, s.k)),
        "extra": sorted(obs - pred, key=lambda s: (s.m, s.n, s.k)),
        "covered": covered,
    }


def arch_workload(cfg, shape_name: str) -> List[GEMMShape]:
    """`model_workload` with (batch, seq, kind) pulled from the registry's
    shape suite (the same cells the dry-run sweep enumerates)."""
    from repro_torch.configs.registry import SHAPES
    spec = SHAPES[shape_name]
    return model_workload(cfg, batch=spec["global_batch"],
                          seq=spec["seq_len"], kind=spec["kind"])
