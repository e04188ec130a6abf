"""On-card smoke check of the PyTorch/CUDA port (needs one NVIDIA H100).

    python3 chip_smoke.py

Phases (any failure exits non-zero and prints no result line):

1. device  — the card's name and power limit (nvidia-smi) and versions;
2. build   — compile every CUDA kernel of the serving path from the
             checkout's sources (`src/repro_torch/kernels/csrc/*.cu`);
3. kernels — each kernel against its plain PyTorch version on the card,
             through the wrapper the main path calls: every input dtype at
             all five gemma-2b decode shapes (lm_head on the full 256000-
             column `embed.T` view), a bm = 2 geometry, a non-power-of-two
             geometry, a ragged shape and a strided B; every kernel variant
             must be reached;
4. serve   — full-width, full-depth gemma-2b (random weights from a seed)
             through `repro_torch.launch.serve`: batch 4, prompt 32, gen
             32. Asserts plan-resolve rate 1.0, no silent degrade, one
             `mmad` launch per routed GEMM dispatch, finite logits, and
             first-step logits that match an unrouted run; then the device
             busy share of the same decode steps, read from one profiled
             window;
5. timing  — per decode shape the kernel's time (held to the tolerance
             again) beside the plain version's, one `torch.matmul` call's
             and the bound;
6. report  — one JSON line per kernel, the nvidia-smi line, and last the
             `{"ok": true, "device": ...}` line.

Exits 2 with no result when no CUDA device is present. Imports nothing of
JAX and nothing of the JAX package.
"""
from __future__ import annotations

import json
import math
import shutil
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
H100_BYTES_PER_S = 3.35e12          # H100 SXM data sheet: HBM3 bandwidth
H100_BF16_FLOPS = 989e12            # H100 SXM data sheet: dense bf16 tensor
BATCH, PROMPT, GEN = 4, 32, 32
SEED = 0
# Routed vs unrouted first-step logits, relative L2. Both runs round each
# of the step's 127 GEMM outputs to bf16 (2^-8 relative) from fp32 sums
# taken in different orders; one-ulp flips then travel through 18 layers of
# untrained random weights, which amplify them (measured 1.8e-2 on an H100).
FIRST_STEP_REL_L2 = 5e-2


def fail(msg: str) -> None:
    print(f"chip_smoke: FAIL: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def phase(name: str) -> None:
    print(f"== {name}", flush=True)


def smi_line() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip().splitlines()
    return out[0]


def wall_ms(torch, fn, iters: int = 20, warmup: int = 3) -> float:
    """Milliseconds per call between CUDA events around `iters` calls:
    device time when the card is the bottleneck, the host's pace when the
    host is (small calls)."""
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def device_kernels(torch, prof):
    """(self device us, calls, name) of each kernel in a profile. Only the
    device-side events count: a CPU op's own device time is the same
    kernels again, and so is a `record_function` span on the device
    timeline (`dit_gemm.<mode>`)."""
    from torch.autograd import DeviceType
    return sorted(((e.self_device_time_total, e.count, e.key)
                   for e in prof.key_averages()
                   if e.device_type == DeviceType.CUDA
                   and not getattr(e, "is_user_annotation", False)
                   and not e.key.startswith("dit_gemm.")), reverse=True)


def device_ms(torch, fn, iters: int = 20, warmup: int = 3) -> float:
    """Device milliseconds per call of `fn`: CUDA events around `iters`
    calls that the host queues behind a spin kernel, so the card runs them
    back to back and host time between launches does not count. Fails if
    the host could not queue them all before the spin ended."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    cycles = 50_000_000                 # ~25 ms at the H100's boost clock
    for _ in range(3):
        torch.cuda._sleep(cycles)
        start.record()
        for _ in range(iters):
            fn()
        end.record()
        queued_ahead = not start.query()
        torch.cuda.synchronize()
        if queued_ahead:
            return start.elapsed_time(end) / iters
        cycles *= 4
    fail("could not queue the timed calls ahead of the card")


def tolerance_ratio(torch, got, want, k: int, out_dtype) -> float:
    """Largest |kernel - plain| over its tolerance (fails above 1): rtol
    1e-5 and atol 1e-5*sqrt(K) for fp32 sums of fp32-exact products taken
    in another order, plus one output ulp for bf16 / fp16 out."""
    ulp = {torch.bfloat16: 2.0 ** -7, torch.float16: 2.0 ** -10}.get(
        out_dtype, 0.0)
    err = (got.float() - want.float()).abs()
    tol = 1e-5 * math.sqrt(k) + (1e-5 + ulp) * want.float().abs()
    return float((err / tol).max())


def check_kernels(torch, mmad_mod, ref) -> float:
    """Kernel vs plain version over dtypes and geometries, through the
    `mmad` wrapper; returns the largest error seen relative to its
    tolerance (must be <= 1)."""
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(SEED)
    dtypes = [torch.float32, torch.bfloat16, torch.float16,
              torch.float8_e4m3fn, torch.int8]
    cases = [
        # (m, k, n, block, transpose_b); the first five are the main path's
        # decode GEMMs at the plan's block geometry
        (4, 2048, 2048, (4, 128, 256), False),      # q, o
        (4, 2048, 256, (4, 256, 128), False),       # k, v
        (4, 2048, 16384, (4, 512, 256), False),     # gate, up
        (4, 16384, 2048, (4, 128, 512), False),     # down
        (4, 2048, 256000, (4, 512, 256), True),     # lm_head: embed.T, unsplit
        (4, 2048, 1000, (4, 512, 256), True),       # column stream, split K
        (2, 512, 384, (2, 128, 128), False),        # bm = 2
        (48, 120, 192, (24, 96, 40), False),        # tile: non-power-of-two
        (5, 130, 7, (8, 128, 128), False),          # tile: ragged
        (200, 300, 260, (128, 128, 128), True),     # tile: strided B
    ]
    n_sms = torch.cuda.get_device_properties(dev).multi_processor_count
    reached = set()
    worst = 0.0
    for dt in dtypes:
        for m, k, n, block, tb in cases:
            def draw(shape):
                if dt == torch.int8:
                    return torch.randint(-8, 9, shape, generator=g,
                                         device=dev).to(dt)
                return torch.randn(shape, generator=g, device=dev).to(dt)
            a = draw((m, k))
            b = draw((n, k)).T if tb else draw((k, n))
            variant, _, splits = mmad_mod.plan_launch(
                m, n, k, block, n_sms, mmad_mod.b_layout(b), b.element_size())
            reached.add((variant, splits == 1))
            outs = ((torch.float32, torch.bfloat16) if dt == torch.bfloat16
                    else (torch.float32,))
            for out_dtype in outs:
                got = mmad_mod.mmad(a, b, block, out_dtype)
                want = ref.mmad_ref(a, b, out_dtype)
                torch.cuda.synchronize()
                ratio = tolerance_ratio(torch, got, want, k, out_dtype)
                worst = max(worst, ratio)
                if not ratio <= 1.0:
                    fail(f"mmad {dt} m={m} k={k} n={n} block={block} "
                         f"transposed={tb} out={out_dtype} variant={variant} "
                         f"splits={splits}: max abs err "
                         f"{float((got.float() - want.float()).abs().max()):.3e}"
                         f" exceeds tolerance (ratio {ratio:.2f})")
            del a, b, got, want
    # every variant, and both ways a stream kernel writes C (directly, or
    # through split-K partials and the reduce kernel)
    need = {(mmad_mod.ROW_STREAM, False), (mmad_mod.COL_STREAM, False),
            (mmad_mod.COL_STREAM, True)}
    if not need <= reached or not any(v == mmad_mod.TILE for v, _ in reached):
        fail(f"kernel variants reached {sorted(reached)}, need {sorted(need)} "
             f"and the tile kernel")
    print(f"mmad vs plain: {len(dtypes)} dtypes x {len(cases)} geometries "
          f"agree (worst err/tol {worst:.3f}; rtol 1e-5, atol 1e-5*sqrt(K), "
          f"+1 ulp for bf16 out); (variant, unsplit) reached: "
          f"{sorted(reached)}", flush=True)
    return worst


def time_decode_shapes(torch, mmad_mod, ref, cfg, launches_per_step, dev):
    """Per gemma-2b decode GEMM: kernel, plain and torch.matmul times and
    the bytes bound, at the plan's block geometry. Weights rotate through
    enough copies to exceed the 50 MB L2, as the decode loop's do."""
    g = torch.Generator(device=dev).manual_seed(SEED + 1)
    rows = []
    for (m, n, k), info in launches_per_step.items():
        block, count = info["block"], info["count"]
        a = torch.randn((m, k), generator=g, device=dev).to(torch.bfloat16)
        w_bytes = k * n * 2
        copies = max(1, math.ceil(120e6 / w_bytes))
        if n == cfg.vocab:          # the tied lm_head: embed.T, a view
            ws = [torch.randn((n, k), generator=g, device=dev)
                  .to(torch.bfloat16).T for _ in range(copies)]
        else:
            ws = [torch.randn((k, n), generator=g, device=dev)
                  .to(torch.bfloat16) for _ in range(copies)]
        it = {"i": 0}

        def nxt():
            it["i"] = (it["i"] + 1) % copies
            return ws[it["i"]]

        got = mmad_mod.mmad(a, ws[0], block, torch.float32)
        want = ref.mmad_ref(a, ws[0], torch.float32)
        ratio = tolerance_ratio(torch, got, want, k, torch.float32)
        if not ratio <= 1.0:
            fail(f"mmad at decode shape {m}x{n}x{k}: error {ratio:.2f}x its "
                 f"tolerance")
        err = float((got - want).abs().max())
        kernel_ms = device_ms(
            torch, lambda: mmad_mod.mmad(a, nxt(), block, torch.float32))
        plain_ms = device_ms(
            torch, lambda: ref.mmad_ref(a, nxt(), torch.float32))
        library_ms = device_ms(torch, lambda: torch.matmul(a, nxt()))
        call_ms = wall_ms(
            torch, lambda: mmad_mod.mmad(a, nxt(), block, torch.float32))
        nbytes = m * k * 2 + k * n * 2 + m * n * 4
        flops = 2 * m * n * k
        t_bytes = nbytes / H100_BYTES_PER_S * 1e3
        t_ops = flops / H100_BF16_FLOPS * 1e3
        row = {"shape": [m, n, k], "block": list(block),
               "launches_per_step": count, "kernel_ms": kernel_ms,
               "plain_ms": plain_ms, "library_ms": library_ms,
               "kernel_call_wall_ms": call_ms,
               "bound_ms": max(t_bytes, t_ops),
               "bound_by": "bytes" if t_bytes >= t_ops else "operations",
               "max_abs_err": err, "err_over_tolerance": ratio}
        print(json.dumps(row), flush=True)
        rows.append(row)
    return rows


def busy_share(torch, params, cfg, planner, prompts, dev,
               unprofiled_step_ms: float) -> None:
    """Device busy time and wall time per decode step, both read from one
    window: the main run's batch, prompts and positions (prefill token by
    token through a fresh routed context, then its GEN decode steps under
    the profiler, the wall clock read inside the profiled window). Only
    device activity is traced: tracing every host op would slow the host,
    and with it the window, severalfold."""
    from repro_torch.launch import serve
    from repro_torch.models import shard_ctx
    from repro_torch.models.model import decode_init
    from repro_torch.train.steps import make_serve_step

    serve.install_gemm_context(planner, dev)
    step = make_serve_step(cfg)
    acts = [torch.profiler.ProfilerActivity.CUDA]
    with torch.inference_mode():
        caches = decode_init(params, cfg, BATCH, PROMPT + GEN)
        for i in range(PROMPT):
            logits, caches = step(params, caches, prompts[:, i:i + 1], i)
        tok = torch.argmax(logits, -1)[:, None]
        with torch.profiler.profile(activities=acts) as prof:
            serve._sync(dev)
            t0 = time.perf_counter()
            for i in range(GEN):
                logits, caches = step(params, caches, tok, PROMPT + i)
                tok = torch.argmax(logits, -1)[:, None]
            serve._sync(dev)
            wall_ms = (time.perf_counter() - t0) * 1e3 / GEN
    shard_ctx.set_gemm_context(None)
    kernels = device_kernels(torch, prof)
    if not kernels:
        fail("torch.profiler recorded no device time")
    busy_ms = sum(us for us, _, _ in kernels) / 1e3 / GEN
    mmad_ms = sum(us for us, _, name in kernels if "mmad" in name) / 1e3 / GEN
    for us, count, name in kernels[:8]:
        print(f"  device {us / 1e3 / GEN:8.3f} ms/step  {count / GEN:7.1f} "
              f"calls/step  {name[:80]}", flush=True)
    print(f"profiled window of {GEN} decode steps (batch {BATCH}, positions "
          f"{PROMPT}-{PROMPT + GEN - 1}): device busy {busy_ms:.3f} ms per "
          f"step ({mmad_ms:.3f} ms in mmad) against {wall_ms:.3f} ms per "
          f"step wall in the same window: busy share {busy_ms / wall_ms:.1%}"
          f"; the rest is host time between launches (the unprofiled main "
          f"run took {unprofiled_step_ms:.3f} ms per step)", flush=True)


def serve_gemma(torch, mmad_mod, cfg, dev):
    from repro_torch.core.lower import lower_schedule
    from repro_torch.launch import serve
    from repro_torch.models import shard_ctx
    from repro_torch.models.model import decode_init, decode_step, init_params
    from repro_torch.obs import render_run_report

    t0 = time.perf_counter()
    params = init_params(torch.Generator(device=dev).manual_seed(SEED), cfg,
                         dev)
    serve._sync(dev)
    print(f"{cfg.name}: {sum(p.numel() for p in params.parameters())} "
          f"parameters ({cfg.n_layers} layers, d_model {cfg.d_model}, "
          f"vocab {cfg.vocab}, {cfg.dtype}) initialised in "
          f"{time.perf_counter() - t0:.2f}s", flush=True)
    plan_dir = ROOT / "build" / "chip_smoke" / "plan_cache"
    shutil.rmtree(plan_dir, ignore_errors=True)
    planner = serve.warm_plan_cache(cfg, BATCH, PROMPT, PROMPT + GEN,
                                    str(plan_dir), (4, 4), 12)
    gen = torch.Generator(device="cpu").manual_seed(SEED)
    prompts = torch.randint(0, cfg.vocab, (BATCH, PROMPT),
                            generator=gen).to(dev)

    # first decode step, unrouted (no context: x @ w) vs routed
    with torch.inference_mode():
        shard_ctx.set_gemm_context(None)
        caches = decode_init(params, cfg, BATCH, PROMPT + GEN)
        plain, _ = decode_step(params, caches, prompts[:, :1], 0, cfg)
        serve.install_gemm_context(planner, dev)
        caches = decode_init(params, cfg, BATCH, PROMPT + GEN)
        routed, _ = decode_step(params, caches, prompts[:, :1], 0, cfg)
    rel = float((routed - plain).norm() / plain.norm())
    max_abs = float((routed - plain).abs().max())
    print(f"first decode step, routed vs unrouted logits: rel L2 {rel:.3e} "
          f"(tolerance {FIRST_STEP_REL_L2}), max abs {max_abs:.3e}, "
          f"greedy tokens equal in "
          f"{int((routed.argmax(-1) == plain.argmax(-1)).sum())}/{BATCH} "
          f"rows", flush=True)
    if not rel <= FIRST_STEP_REL_L2:
        fail(f"routed first-step logits differ from unrouted: rel L2 {rel}")

    # the main path: a fresh routing context, counts from zero
    ctx = serve.install_gemm_context(planner, dev)
    mmad_mod.reset_launch_count()
    out = serve.generate(params, cfg, prompts, GEN)
    launches = mmad_mod.launch_count()
    stats = ctx.stats
    report = serve.build_serve_report(ctx, cfg, BATCH, PROMPT + GEN)
    for line in render_run_report(report):
        print(line, flush=True)
    shard_ctx.set_gemm_context(None)

    logits = out["logits"]
    if not bool(torch.isfinite(logits).all()):
        fail("non-finite logits")
    if tuple(logits.shape) != (BATCH, cfg.vocab):
        fail(f"logits shape {tuple(logits.shape)}")
    if stats.resolve_rate != 1.0:
        fail(f"plan-resolve rate {stats.resolve_rate}")
    if stats.silent_degrades:
        fail(f"{stats.silent_degrades} silent degrades")
    if launches == 0 or launches != stats.executed_gemm:
        fail(f"mmad launched {launches} times for "
             f"{stats.executed_gemm} routed GEMM dispatches")
    busy_share(torch, params, cfg, planner, prompts, dev,
               out["t_gen"] / GEN * 1e3)

    tok_s = BATCH * GEN / out["t_gen"]
    card = (torch.cuda.get_device_name(dev) if dev.type == "cuda"
            else str(dev))
    print(f"serve {cfg.name} on {card}: prefill "
          f"{PROMPT} tok in {out['t_prefill']:.3f}s, decode {GEN} tok in "
          f"{out['t_gen']:.3f}s = {tok_s:.1f} tok/s at batch {BATCH}; "
          f"{launches} mmad launches = {stats.executed_gemm} routed GEMM "
          f"dispatches, resolve rate {stats.resolve_rate}", flush=True)
    print("sample generations:", out["tokens"][:2, :8].tolist(), flush=True)

    # what one decode step launches, per shape, at the plan's geometry
    steps = PROMPT + GEN
    per_step = {}
    for (tag, shape), _ in stats.observed.items():
        plan = planner.plan_cached(shape)
        ep = lower_schedule(plan.schedule, ctx.mesh, shape=shape)
        key = (shape.m, shape.n, shape.k)
        rec = per_step.setdefault(key, {"block": ep.inner_kernel.geometry(),
                                        "count": 0})
        rec["count"] += cfg.n_layers if tag != "lm_head" else 1
    if sum(r["count"] for r in per_step.values()) * steps != launches:
        fail("per-step launch table does not add up to the launches")
    return launches, per_step


def main() -> int:
    try:
        import torch
    except ImportError:
        print("chip_smoke: torch is not installed", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this check runs on the card",
              file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    # plain versions and the unrouted yardstick in full fp32 / fp32-reduced
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
    from repro_torch.kernels import build, ref
    import importlib
    mmad_mod = importlib.import_module("repro_torch.kernels.mmad")

    phase("device")
    smi = smi_line()
    print(smi, flush=True)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} python "
          f"{sys.version.split()[0]} devices {torch.cuda.device_count()}",
          flush=True)

    phase("build")
    t0 = time.perf_counter()
    lib, seconds = build.build("mmad")
    print(f"built {lib.name} in {seconds:.1f}s "
          f"(phase {time.perf_counter() - t0:.1f}s)", flush=True)

    phase("kernels vs plain")
    check_kernels(torch, mmad_mod, ref)

    phase("serve")
    from repro_torch.configs import get_config
    cfg = get_config("gemma-2b")
    dev = torch.device("cuda")
    launches, per_step = serve_gemma(torch, mmad_mod, cfg, dev)

    # times below are per gemma-2b decode step at batch 4: the sum over the
    # step's launches of each shape's time
    phase("kernel timing")
    rows = time_decode_shapes(torch, mmad_mod, ref, cfg, per_step, dev)

    def per_step_ms(key):
        return sum(r[key] * r["launches_per_step"] for r in rows)

    print(json.dumps({"kernels": [{
        "name": "mmad", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/mmad.cu",
        "replaces": "src/repro/kernels/mmad.py:80",
        "launches": launches,
        "max_abs_err": max(r["max_abs_err"] for r in rows),
        "ms": per_step_ms("kernel_ms"),
        "plain_ms": per_step_ms("plain_ms"),
        "bound_ms": per_step_ms("bound_ms"),
        "bound_by": "bytes" if all(r["bound_by"] == "bytes" for r in rows)
        else "operations",
        "library_ms": per_step_ms("library_ms"),
    }]}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
