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

Runs on the card unless `--device cpu` is given; with no card it raises.

  PYTHONPATH=src python -m repro_torch.launch.serve --arch gemma-2b \\
      --batch 4 --prompt-len 32 --gen 32
"""
from __future__ import annotations

import argparse
import time
from typing import Dict, Optional

import numpy as np
import torch

from repro_torch.configs import get_config, smoke_config
from repro_torch.deploy import Planner, model_workload, workload_coverage
from repro_torch.deploy.warmup import add_plan_args, build_planner, warm_buckets
from repro_torch.launch.mesh import make_host_mesh, resolve_device
from repro_torch.models import shard_ctx
from repro_torch.models.model import decode_init, init_params
from repro_torch.obs import (DriftMonitor, Tracer, build_run_report,
                             render_run_report, set_tracer, write_run_report)
from repro_torch.obs.trace import maybe_span
from repro_torch.train.steps import make_serve_step


def warm_plan_cache(cfg, batch: int, prompt_len: int, max_len: int,
                    cache_dir: str, grid, max_candidates: int,
                    online_tune: bool = True) -> Planner:
    """Batch-tune the model's (bucketed) GEMM workload into the plan cache:
    the batched-prefill shapes (M = batch*prompt_len, a real deployment's
    artifact) and the decode shapes (M = batch) this loop executes."""
    planner = build_planner(cache_dir, grid, max_candidates,
                            online_tune=online_tune)
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


def load_drift(plan_cache: str, plan_grid) -> Optional[dict]:
    """Drift of the persisted calibration profile vs its persisted
    measurement samples, or None when the cache dir carries none."""
    from repro_torch.hw.config import tpu_pod_as_accelerator
    from repro_torch.sim import calibrate as cal
    hw = tpu_pod_as_accelerator(tuple(plan_grid))
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
    drift = load_drift(plan_cache, plan_grid) if plan_cache else None
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
def generate(params, cfg, prompts: torch.Tensor, gen: int,
             temperature: float = 0.0,
             generator: Optional[torch.Generator] = None) -> dict:
    """Prefill `prompts` (B, P) token by token through the cache, then
    decode `gen` tokens. Clocks are read after a device synchronize.

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
            logits, caches = serve(params, caches, prompts[:, i:i + 1], i)
    _sync(device)
    t_prefill = time.perf_counter() - t0

    generated = []
    tok = torch.argmax(logits, -1)[:, None]
    _sync(device)
    t0 = time.perf_counter()
    for i in range(gen):
        generated.append(tok[:, 0])
        with maybe_span("serve.decode_token", position=i):
            logits, caches = serve(params, caches, tok, prompt_len + i)
        if temperature > 0:
            probs = torch.softmax(logits / temperature, dim=-1)
            tok = torch.multinomial(probs, 1, generator=generator)
        else:
            tok = torch.argmax(logits, -1)[:, None]
    _sync(device)
    t_gen = time.perf_counter() - t0
    return {"tokens": torch.stack(generated, 1), "logits": logits,
            "t_prefill": t_prefill, "t_gen": t_gen}


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
                    help="multi-tenant traffic replay (not yet ported)")
    ap.add_argument("--run-report", default="results/serve_run_report.json",
                    help="where to write the versioned run report "
                         "('' disables)")
    ap.add_argument("--trace", default="",
                    help="write a Perfetto-loadable Chrome trace here")
    add_plan_args(ap)
    args = ap.parse_args(argv)

    if args.traffic:
        raise NotImplementedError(
            "--traffic is not yet ported: it waits for launch/traffic.py "
            "(ROADMAP.md, queue 1: launchers and serving)")

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
                                    online_tune=not args.no_online_tune)
        else:
            planner = warm_plan_cache(cfg, args.batch, args.prompt_len,
                                      max_len, args.plan_cache,
                                      args.plan_grid, args.plan_candidates,
                                      online_tune=not args.no_online_tune)
        if not args.no_plan_routing:
            gemm_ctx = install_gemm_context(planner, device)
            tracer = Tracer(process_name=f"serve.{cfg.name}")
            set_tracer(tracer)

    prompts = torch.as_tensor(
        rng.integers(0, cfg.vocab, (args.batch, args.prompt_len)),
        dtype=torch.long, device=device)
    sampler = torch.Generator(device=device).manual_seed(args.seed + 1)
    out = generate(params, cfg, prompts, args.gen,
                   temperature=args.temperature, generator=sampler)
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
