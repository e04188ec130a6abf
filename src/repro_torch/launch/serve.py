"""Serving launcher: token-by-token prefill + decode against preallocated KV
caches, with every model matmul routed through the deployment planner.

Port of the fixed-batch path of `repro/launch/serve.py`. At startup the
deployment-plan cache is warmed for the model's GEMM workload (bucketed +
exact shapes) and the decode-path schedules are reported. The warmed
planner is then installed as the model stack's `GemmContext`, so every
`pmm` matmul dispatches through `dit_gemm` under its tuned schedule and
runs its arithmetic in the `mmad` CUDA kernel. At shutdown the launcher
reports the plan-resolve rate over the matmuls the model actually ran and
cross-validates `model_workload`'s prediction against them.

Every ported architecture serves this way (`--arch` gemma-2b, olmo-1b,
phi4-mini-3.8b, qwen3-14b, deepseek-moe-16b, deepseek-v2-236b, whose MLA
decodes in the absorbed form, zamba2-1.2b and xlstm-1.3b, which decode on
their recurrent state, seamless-m4t-medium, an encoder-decoder, and
phi-3-vision-4.2b, which decodes text only as the reference's launcher
does): an encoder-decoder's decoder attends to `encoder_output`, random
frames through `frontend_proj` as the reference's launcher makes it, at
every prefill and decode step; an MoE model's router and
shared experts are routed GEMMs, and its expert einsums are recorded under
the tags `model_workload` predicts, so the warm-up covers them and the
cross-validation holds; the recurrent stacks' projections are routed
GEMMs and their scans run outside `mmad`. Runs on the card unless `--device cpu` is given;
with no card it raises.

`--traffic` replays a seeded multi-tenant Poisson trace through the
shape-bucket-aware continuous batcher instead (`run_traffic`,
`launch/traffic.py`): the virtual clock does the SLO accounting, and each
distinct GEMM shape the replay admits runs once through the routed `pmm`
on the card.

  PYTHONPATH=src python -m repro_torch.launch.serve --arch deepseek-moe-16b \\
      --batch 4 --prompt-len 32 --gen 32
  PYTHONPATH=src python -m repro_torch.launch.serve --arch gemma-2b \\
      --traffic --batch-mode fifo
"""
from __future__ import annotations

import argparse
import time
from typing import Dict, Optional

import numpy as np
import torch

from repro_torch.configs import get_config, smoke_config
from repro_torch.deploy import Planner, model_workload, workload_coverage
from repro_torch.deploy.batcher import BATCH_MODES, BatchPolicy
from repro_torch.deploy.warmup import add_plan_args, build_planner, warm_buckets
from repro_torch.launch.mesh import make_host_mesh, resolve_device
from repro_torch.models import shard_ctx
from repro_torch.models.matmul import pmm
from repro_torch.models.model import decode_init, init_params
from repro_torch.obs import (DriftMonitor, Tracer, build_run_report,
                             render_run_report, set_tracer, write_run_report)
from repro_torch.obs.trace import CAT_STEP, maybe_span
from repro_torch.train.steps import make_serve_step


def warm_plan_cache(cfg, batch: int, prompt_len: int, max_len: int,
                    cache_dir: str, grid, max_candidates: int,
                    online_tune: bool = True, device=None) -> Planner:
    """Batch-tune the model's (bucketed) GEMM workload into the plan cache,
    priced on the view of `device` (`deploy.warmup.plan_view`): the
    batched-prefill shapes (M = batch*prompt_len, a real deployment's
    artifact) and the decode shapes (M = batch) this loop executes."""
    planner = build_planner(cache_dir, grid, max_candidates,
                            online_tune=online_tune, device=device)
    decode = model_workload(cfg, batch, max_len, kind="decode")
    workload = model_workload(cfg, batch, prompt_len, kind="prefill") + decode
    warm_buckets(planner, workload)
    plans = {shape: planner.plan(shape)
             for shape in dict.fromkeys(workload)}
    for shape in list(dict.fromkeys(decode))[:4]:
        plan = plans[shape]
        print(f"  decode {shape.m}x{shape.n}x{shape.k}: "
              f"{plan.schedule.describe()} "
              f"est={plan.report.total_time*1e6:.2f}us [{plan.source}]")
    return planner


def install_gemm_context(planner: Planner,
                         device="cuda") -> shard_ctx.GemmContext:
    """Route the model stack's matmuls through the warmed planner on the
    1x1 mesh of `device`."""
    ctx = shard_ctx.GemmContext(mesh=make_host_mesh(device), planner=planner)
    shard_ctx.set_gemm_context(ctx)
    return ctx


def load_drift(plan_cache: str, plan_grid, device=None,
               mesh=None) -> Optional[dict]:
    """Drift of the persisted calibration profile of the view the plans
    were priced on (`deploy.warmup.plan_view`) vs its persisted
    measurement samples, or None when the cache dir carries none."""
    from repro_torch.deploy.warmup import plan_view
    from repro_torch.sim import calibrate as cal
    hw = plan_view(plan_grid, device, mesh)
    profile = cal.load_profile(plan_cache, hw)
    samples = cal.load_samples(plan_cache, hw)
    if profile is None or not samples:
        return None
    mon = DriftMonitor(profile)
    mon.add_samples(samples)
    return mon.summary()


def build_serve_report(ctx: shard_ctx.GemmContext, cfg, batch: int,
                       max_len: int, plan_cache: str = "",
                       plan_grid=(4, 4), tracer=None,
                       extra: Optional[Dict[str, object]] = None) -> dict:
    """The versioned run report: routing stats + model_workload
    cross-validation (decode shapes: this loop prefills token by token)
    + calibration drift + per-dispatch provenance."""
    stats = ctx.stats
    predicted = model_workload(cfg, batch, max_len, kind="decode")
    cov = workload_coverage(predicted, stats.observed_shapes())
    workload = {
        "observed": len(stats.observed_shapes()),
        "predicted": len(predicted),
        "covered": cov["covered"],
        "extra": [[s.m, s.n, s.k] for s in cov["extra"]],
        "missing": [[s.m, s.n, s.k] for s in cov["missing"]],
    }
    drift = (load_drift(plan_cache, plan_grid, mesh=ctx.mesh)
             if plan_cache else None)
    return build_run_report("serve", stats=stats.to_dict(),
                            workload=workload, drift=drift, tracer=tracer,
                            extra={"arch": cfg.name, "batch": batch,
                                   "max_len": max_len, **(extra or {})})


def report_routing(ctx: shard_ctx.GemmContext, cfg, batch: int,
                   max_len: int) -> None:
    """Shutdown print, rendered from the same dict the run report writes."""
    for line in render_run_report(build_serve_report(ctx, cfg, batch,
                                                     max_len)):
        print(line)


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


@torch.inference_mode()
def encoder_output(params, cfg, batch: int, rng: np.random.Generator,
                   device) -> torch.Tensor:
    """An encoder-decoder's stand-in encoder output, as the reference's
    launcher makes it: random frames (batch, n_prefix, d_model) x 0.02 from
    `rng`, in `cfg.dtype`, times `frontend_proj` — a plain matmul there,
    not a routed GEMM, so a plain `torch.matmul` here."""
    frames = torch.as_tensor(
        rng.standard_normal((batch, cfg.n_prefix, cfg.d_model)) * 0.02,
        dtype=cfg.dtype, device=device)
    return torch.matmul(frames, params.frontend_proj)


@torch.inference_mode()
def generate(params, cfg, prompts: torch.Tensor, gen: int,
             temperature: float = 0.0,
             generator: Optional[torch.Generator] = None,
             encoder_out: Optional[torch.Tensor] = None) -> dict:
    """Prefill `prompts` (B, P) token by token through the cache, then
    decode `gen` tokens; an encoder-decoder's every step attends to
    `encoder_out`. Clocks are read after a device synchronize.

    Returns the generated tokens (B, gen), the last logits, and the
    prefill / decode wall seconds."""
    device = prompts.device
    batch, prompt_len = prompts.shape
    caches = decode_init(params, cfg, batch, prompt_len + gen)
    serve = make_serve_step(cfg)

    _sync(device)
    t0 = time.perf_counter()
    logits = None
    for i in range(prompt_len):
        with maybe_span("serve.prefill_token", position=i):
            logits, caches = serve(params, caches, prompts[:, i:i + 1], i,
                                   encoder_out)
    _sync(device)
    t_prefill = time.perf_counter() - t0

    generated = []
    tok = torch.argmax(logits, -1)[:, None]
    _sync(device)
    t0 = time.perf_counter()
    for i in range(gen):
        generated.append(tok[:, 0])
        with maybe_span("serve.decode_token", position=i):
            logits, caches = serve(params, caches, tok, prompt_len + i,
                                   encoder_out)
        if temperature > 0:
            probs = torch.softmax(logits / temperature, dim=-1)
            tok = torch.multinomial(probs, 1, generator=generator)
        else:
            tok = torch.argmax(logits, -1)[:, None]
    _sync(device)
    t_gen = time.perf_counter() - t0
    return {"tokens": torch.stack(generated, 1), "logits": logits,
            "t_prefill": t_prefill, "t_gen": t_gen}


def run_traffic(args) -> dict:
    """`--traffic` mode: replay a seeded multi-tenant trace through the
    continuous batcher against the warmed planner. Returns the run report.

    The virtual-clock loop in `launch/traffic.py` does the SLO accounting;
    every distinct GEMM shape the replay admits runs once through the
    routed `pmm` on `args.device`, on zeros of the model's dtype (the
    reference's trace-time semantics: one execution per shape). The run
    report gains the `serving` and `traffic` sections and the tracer one
    `serve.request` marker per request."""
    from repro_torch.launch.traffic import (TenantSpec, TrafficConfig,
                                            generate_trace, serving_section,
                                            simulate, warm_pool)
    device = resolve_device(args.device)
    cfg = smoke_config(args.arch) if args.smoke else get_config(args.arch)
    policy = BatchPolicy(mode=args.batch_mode)
    tenants = tuple(
        TenantSpec(name=f"tenant{i}", arch=cfg.name,
                   rate_rps=args.traffic_rate,
                   n_requests=args.traffic_requests,
                   prompt_lens=(5, 9, 13, 17), gen_lens=(2, 3, 5))
        for i in range(args.traffic_tenants))
    tcfg = TrafficConfig(seed=args.traffic_seed, tenants=tenants)
    cfgs = {t.name: cfg for t in tenants}

    planner = build_planner(args.plan_cache, args.plan_grid,
                            args.plan_candidates,
                            online_tune=not args.no_online_tune,
                            device=device)
    warmed = warm_pool(planner, {cfg.name: cfg}, policy,
                       tcfg.max_rows(policy))
    print(f"traffic: warmed {len(warmed)} pool shape(s) "
          f"[mode={policy.mode}]")
    gemm_ctx = install_gemm_context(planner, device)
    tracer = Tracer(process_name=f"serve.traffic.{cfg.name}")
    set_tracer(tracer)

    @torch.inference_mode()
    def dispatch(shape, phase):
        # one routed execution per distinct shape the replay admits
        x = torch.zeros((shape.m, shape.k), dtype=cfg.dtype, device=device)
        w = torch.zeros((shape.k, shape.n), dtype=cfg.dtype, device=device)
        pmm(x, w, tag=f"traffic.{phase}")
        _sync(device)

    trace = generate_trace(tcfg)
    t0 = time.perf_counter()
    result = simulate(trace, planner, cfgs, policy=policy,
                      precompiled=warmed, dispatch=dispatch)
    wall = time.perf_counter() - t0
    section = serving_section(result)
    for rec in result.records:
        tracer.instant("serve.request", cat=CAT_STEP, rid=rec.rid,
                       tenant=rec.tenant,
                       arrival_s=round(rec.arrival_s, 6),
                       ttft_s=round(rec.ttft_s, 6),
                       latency_s=round(rec.latency_s, 6), met=rec.met)
    print(f"traffic replay: {len(trace)} requests / "
          f"{len(tenants)} tenant(s), {section['batches']} batches, "
          f"{section['distinct_shapes']} distinct GEMM shape(s) "
          f"dispatched on {device} in {wall:.2f}s wall "
          f"({section['makespan_s']:.3f}s virtual)")
    report = build_run_report(
        "serve", stats=gemm_ctx.stats.to_dict(), tracer=tracer,
        extra={"arch": cfg.name, "device": str(device), "serving": section,
               "traffic": {"seed": tcfg.seed, "tenants": len(tenants),
                           "requests": len(trace),
                           "rate_rps": args.traffic_rate,
                           "batch_mode": policy.mode}})
    for line in render_run_report(report):
        print(line)
    if args.run_report:
        write_run_report(args.run_report, report)
        print(f"run report: {args.run_report}")
    if args.trace:
        tracer.write(args.trace)
        print(f"chrome trace: {args.trace}")
    return report


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--device", default="cuda",
                    help="torch device to serve on (default: the card; "
                         "'cpu' runs the kernels' plain versions)")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--gen", type=int, default=32)
    ap.add_argument("--temperature", type=float, default=0.0)
    ap.add_argument("--seed", type=int, default=0,
                    help="seed of the random weights and prompts")
    ap.add_argument("--no-plan-routing", action="store_true",
                    help="warm the cache but keep matmuls un-routed")
    ap.add_argument("--cold-serve", action="store_true",
                    help="skip the workload warm-up: every GEMM resolves "
                         "through the planner's online (analytic) path")
    ap.add_argument("--refine-pending", type=int, default=0, metavar="N",
                    help="after serving, full-tune up to N bucket/analytic-"
                         "served shapes and upgrade their cache entries")
    ap.add_argument("--traffic", action="store_true",
                    help="replay a seeded multi-tenant traffic trace "
                         "through the shape-bucket-aware continuous "
                         "batcher instead of the fixed-batch loop")
    ap.add_argument("--traffic-requests", type=int, default=12,
                    help="requests per tenant in the replayed trace")
    ap.add_argument("--traffic-rate", type=float, default=100.0,
                    help="per-tenant Poisson arrival rate (req/s)")
    ap.add_argument("--traffic-seed", type=int, default=0,
                    help="trace seed (same seed -> identical trace)")
    ap.add_argument("--traffic-tenants", type=int, default=2,
                    help="concurrent tenants sharing the card + plan cache")
    ap.add_argument("--batch-mode", choices=BATCH_MODES, default="bucket",
                    help="admission policy: bucket-aware (default) or the "
                         "naive-FIFO baseline")
    ap.add_argument("--run-report", default="results/serve_run_report.json",
                    help="where to write the versioned run report "
                         "('' disables)")
    ap.add_argument("--trace", default="",
                    help="write a Perfetto-loadable Chrome trace here")
    add_plan_args(ap)
    args = ap.parse_args(argv)

    if args.traffic:
        return run_traffic(args)

    device = resolve_device(args.device)
    cfg = smoke_config(args.arch) if args.smoke else get_config(args.arch)
    gen_weights = torch.Generator(device=device).manual_seed(args.seed)
    params = init_params(gen_weights, cfg, device)
    rng = np.random.default_rng(args.seed)

    max_len = args.prompt_len + args.gen
    gemm_ctx = None
    planner = None
    tracer = None
    if not args.skip_plan_warmup:
        if args.cold_serve:
            planner = build_planner(args.plan_cache, args.plan_grid,
                                    args.plan_candidates,
                                    online_tune=not args.no_online_tune,
                                    device=device)
        else:
            planner = warm_plan_cache(cfg, args.batch, args.prompt_len,
                                      max_len, args.plan_cache,
                                      args.plan_grid, args.plan_candidates,
                                      online_tune=not args.no_online_tune,
                                      device=device)
        if not args.no_plan_routing:
            gemm_ctx = install_gemm_context(planner, device)
            tracer = Tracer(process_name=f"serve.{cfg.name}")
            set_tracer(tracer)

    prompts = torch.as_tensor(
        rng.integers(0, cfg.vocab, (args.batch, args.prompt_len)),
        dtype=torch.long, device=device)
    encoder_out = (encoder_output(params, cfg, args.batch, rng, device)
                   if cfg.is_encoder_decoder else None)
    sampler = torch.Generator(device=device).manual_seed(args.seed + 1)
    out = generate(params, cfg, prompts, args.gen,
                   temperature=args.temperature, generator=sampler,
                   encoder_out=encoder_out)
    t_prefill, t_gen = out["t_prefill"], out["t_gen"]

    gen = out["tokens"].cpu().numpy()
    print(f"arch={cfg.name} device={device} batch={args.batch} "
          f"prefill {args.prompt_len} tok in {t_prefill:.2f}s | "
          f"decode {args.gen} tok in {t_gen:.2f}s "
          f"({args.batch * args.gen / max(t_gen, 1e-9):.1f} tok/s)")
    print("sample generations (token ids):")
    for row in gen[:2]:
        print(" ", row[:16].tolist())
    if planner is not None and args.refine_pending \
            and planner.pending_refinements:
        recs = planner.refine_pending(limit=args.refine_pending)
        print(f"refinement: full-tuned {len(recs)} online/bucket-served "
              f"shape(s); "
              f"{sum(1 for _, old, new in recs if new < old)} improved "
              f"(every refined entry is now tuned-provenance)")
    if gemm_ctx is not None:
        report = build_serve_report(gemm_ctx, cfg, args.batch, max_len,
                                    plan_cache=args.plan_cache,
                                    plan_grid=args.plan_grid, tracer=tracer,
                                    extra={"device": str(device)})
        for line in render_run_report(report):
            print(line)
        if args.run_report:
            write_run_report(args.run_report, report)
            print(f"run report: {args.run_report}")
        if args.trace and tracer is not None:
            tracer.write(args.trace)
            print(f"chrome trace: {args.trace}")


if __name__ == "__main__":
    main()
