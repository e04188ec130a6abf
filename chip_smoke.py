"""On-card smoke check of the PyTorch/CUDA port (needs one NVIDIA H100).

    python3 chip_smoke.py

Phases (any failure exits non-zero and prints no result line):

1. device  — the card's name and power limit (nvidia-smi) and versions;
2. build   — compile every CUDA kernel of the main paths from the
             checkout's sources (`src/repro_torch/kernels/csrc/*.cu`);
3. kernels — each kernel against its plain PyTorch version on the card,
             through the wrapper the main path calls: every input dtype at
             all five gemma-2b decode shapes (lm_head on the full 256000-
             column `embed.T` view), a bm = 2 geometry, a non-power-of-two
             geometry, a ragged shape and a strided B; both stream kernels
             must be reached split and unsplit, and the tile kernel; and
             bf16 at the five gemma-2b train shapes (M = 2048; lm_head per
             loss chunk, M = 1024, on `embed.T`);
4. serve   — full-width, full-depth gemma-2b (random weights from a seed)
             through `repro_torch.launch.serve`: batch 4, prompt 32, gen
             32. Asserts plan-resolve rate 1.0, no silent degrade, one
             `mmad` launch per routed GEMM dispatch, finite logits, and
             first-step logits that match an unrouted run; then the device
             busy share of the same decode steps, read from one profiled
             window (`device_profile`: padded at its edges, which the
             profiler may lose), in which every routed GEMM must be one
             mmad kernel and no split-K reduce kernel may run;
5. train   — full-width, full-depth gemma-2b (random weights from a
             seed) through `repro_torch.launch.train`'s own setup: batch 2,
             seq 1024, lr 1e-4, three steps on one fixed `SyntheticLM`
             batch with per-layer remat, first unrouted (the yardstick),
             then routed from the same weights. Asserts plan-resolve rate
             1.0, no silent degrade, one `mmad` launch per routed GEMM
             dispatch (forward and recompute), finite losses and grad
             norms, a routed trajectory that follows the unrouted one (loss
             before each step and after the last, grad norm of each step,
             every step moving the loss the same way) and a loss that ends
             below its start; then one profiled step, in which every `mmad`
             kernel must be the tile kernel or its split-K reduce. Then
             the crash-resume loop at smoke width on the card: a failure
             injected at step 3 with a checkpoint every 2 steps must end
             on the parameters of an uninterrupted run, bitwise;
6. timing  — per decode shape and per train shape the kernel's time (held
             to the tolerance again) beside the plain version's, one
             `torch.matmul` call's, the bound and the roofline share (bound
             / kernel time); per train shape also the backward's two fp32
             `torch.matmul`s;
7. report  — one JSON line per kernel, the nvidia-smi line, and last the
             `{"ok": true, "device": ...}` line.

Exits 2 with no result when no CUDA device is present. Imports nothing of
JAX and nothing of the JAX package.
"""
from __future__ import annotations

import json
import contextlib
import math
import shutil
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
H100_BYTES_PER_S = 3.35e12          # H100 SXM data sheet: HBM3 bandwidth
H100_BF16_FLOPS = 989.4e12          # H100 SXM data sheet: dense bf16 tensor
BATCH, PROMPT, GEN = 4, 32, 32
SEED = 0
# the train phase: the longest sequence the ported attention takes without
# `chunked_sdpa`; two loss chunks of 512. At lr 1e-3 (the launcher's
# default) Adam's first sign-like steps overshoot on full-width random
# gemma-2b, routed and unrouted alike: the loss over three steps on one
# batch went 12.83 -> 10.38 -> 11.65, then 17.1; at lr <= 3e-4 it ends below
# its start (tools/train_lr_probe.py, on an H100)
TRAIN_BATCH, TRAIN_SEQ, TRAIN_STEPS, TRAIN_LR = 2, 1024, 3, 1e-4
# The routed train run against an unrouted one from the same weights on the
# same batch, relative: the loss before each step and after the last, and
# each step's grad global norm. The unrouted run is cuBLAS bf16 GEMMs and
# PyTorch's own backward; the routed one is mmad with fp32 sums and
# local_matmul's fp32 backward. Both round every GEMM output and every
# gradient to bf16 (2^-8 relative) at other points. On an H100, step 0 read
# 7.7e-5 (loss) and 8.0e-5 (grad norm); later steps, which start from
# parameters the two runs moved with those different grads, read at most
# 2.8e-4 (loss) and 5.5e-4 (grad norm). Each limit is about ten times its
# reading.
STEP0_REL = 1e-3
LATER_LOSS_REL, LATER_GNORM_REL = 3e-3, 5e-3
# (m, k, n, block, transposed B): gemma-2b's train GEMMs at batch 2 x seq
# 1024 and the plans' block geometry (the tile kernel reads only bk)
TRAIN_CASES = [
    (2048, 2048, 2048, (512, 512, 512), False),     # q, o
    (2048, 2048, 256, (128, 256, 512), False),      # k, v: split K
    (2048, 2048, 16384, (512, 512, 512), False),    # gate, up
    (2048, 16384, 2048, (512, 512, 512), False),    # down
    (1024, 2048, 256000, (512, 128, 512), True),    # lm_head chunk, embed.T
]
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


# Edges of a profiled window. On an H100 (torch 2.11, cu128) a device-only
# window of 32 decode steps, synchronized at both ends, does not always
# hold every kernel the card ran in it: in 5 of 8 windows the profile lost
# some of the first ones, from 2 to 1,317 of 51,168, mmad among them
# (tools/profile_edge_probe.py). So the counted work starts after a host
# pause and a run of spin kernels that absorb the loss, and ends before
# another such run and pause; a window that lost all of its leading or
# trailing spin kernels fails rather than count short.
PROFILE_EDGE_S, PROFILE_EDGE_KERNELS = 0.25, 1000
SPIN_KERNEL = "spin_kernel"             # what torch.cuda._sleep launches


@contextlib.contextmanager
def device_profile(torch, dev):
    """A device-only `torch.profiler` window around the block's work, with
    `PROFILE_EDGE_S` of host pause and `PROFILE_EDGE_KERNELS` spin kernels
    at each edge; yields the profiler. `device_kernels` leaves the spin
    kernels out."""
    acts = [torch.profiler.ProfilerActivity.CUDA]
    torch.cuda.synchronize(dev)
    with torch.profiler.profile(activities=acts) as prof:
        time.sleep(PROFILE_EDGE_S)
        for _ in range(PROFILE_EDGE_KERNELS):
            torch.cuda._sleep(100)
        yield prof
        for _ in range(PROFILE_EDGE_KERNELS):
            torch.cuda._sleep(100)
        torch.cuda.synchronize(dev)
        time.sleep(PROFILE_EDGE_S)


def edge_kernels_kept(torch, prof) -> tuple[int, int]:
    """How many of a `device_profile` window's leading and trailing spin
    kernels the profile holds. Fails if it holds none at either edge: the
    profile may then have lost counted work too."""
    from torch.autograd import DeviceType
    names = [e.name for e in sorted(
        (e for e in prof.events() if e.device_type == DeviceType.CUDA
         and not getattr(e, "is_user_annotation", False)
         and not e.name.startswith("dit_gemm.")),
        key=lambda e: e.time_range.start)]
    work = [i for i, name in enumerate(names) if SPIN_KERNEL not in name]
    if not work:
        fail("the profiled window holds no device work")
    lead, trail = work[0], len(names) - 1 - work[-1]
    if not (lead and trail):
        fail(f"the profiled window kept {lead} leading and {trail} trailing "
             f"of its {PROFILE_EDGE_KERNELS} edge kernels")
    return lead, trail


def device_kernels(torch, prof):
    """(self device us, calls, name) of each kernel in a profile. Only the
    device-side events count: a CPU op's own device time is the same
    kernels again, and so is a `record_function` span on the device
    timeline (`dit_gemm.<mode>`); `device_profile`'s edge kernels are
    not the window's work."""
    from torch.autograd import DeviceType
    return sorted(((e.self_device_time_total, e.count, e.key)
                   for e in prof.key_averages()
                   if e.device_type == DeviceType.CUDA
                   and not getattr(e, "is_user_annotation", False)
                   and not e.key.startswith("dit_gemm.")
                   and SPIN_KERNEL not in e.key), reverse=True)


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
        (4, 2048, 256, (4, 512, 256), True),        # column stream, split K
        (4, 512, 270336, (4, 512, 256), False),     # row stream, no fixup
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
    # every variant, and both ways each stream kernel writes C: directly,
    # or through split-K partials that its last split sums in the same launch
    need = {(v, unsplit) for v in (mmad_mod.ROW_STREAM, mmad_mod.COL_STREAM)
            for unsplit in (False, True)}
    if not need <= reached or not any(v == mmad_mod.TILE for v, _ in reached):
        fail(f"kernel variants reached {sorted(reached)}, need {sorted(need)} "
             f"and the tile kernel")
    print(f"mmad vs plain: {len(dtypes)} dtypes x {len(cases)} geometries "
          f"agree (worst err/tol {worst:.3f}; rtol 1e-5, atol 1e-5*sqrt(K), "
          f"+1 ulp for bf16 out); (variant, unsplit) reached: "
          f"{sorted(reached)}", flush=True)
    # the train path's GEMMs: bf16 at the plan's block geometry, all on the
    # tile kernel (M > STREAM_MAX_M)
    for m, k, n, block, tb in TRAIN_CASES:
        a = torch.randn((m, k), generator=g, device=dev).to(torch.bfloat16)
        b = (torch.randn((n, k), generator=g, device=dev).to(torch.bfloat16).T
             if tb else torch.randn((k, n), generator=g,
                                    device=dev).to(torch.bfloat16))
        variant, _, splits = mmad_mod.plan_launch(
            m, n, k, block, n_sms, mmad_mod.b_layout(b), b.element_size())
        if variant != mmad_mod.TILE:
            fail(f"train shape {m}x{n}x{k} would not run the tile kernel")
        for out_dtype in (torch.float32, torch.bfloat16):
            got = mmad_mod.mmad(a, b, block, out_dtype)
            want = ref.mmad_ref(a, b, out_dtype)
            torch.cuda.synchronize()
            ratio = tolerance_ratio(torch, got, want, k, out_dtype)
            worst = max(worst, ratio)
            if not ratio <= 1.0:
                fail(f"mmad train shape {m}x{n}x{k} transposed={tb} "
                     f"out={out_dtype} splits={splits}: error {ratio:.2f}x "
                     f"its tolerance")
        del a, b, got, want
    print(f"mmad vs plain at the {len(TRAIN_CASES)} train shapes (bf16 in, "
          f"fp32 and bf16 out): agree (worst err/tol so far {worst:.3f})",
          flush=True)
    return worst


def time_shapes(torch, mmad_mod, ref, cfg, table, dev, seed: int,
                train: bool = False):
    """Per GEMM shape of one step (`table`: (m, n, k) -> the plan's block
    and the launches per step): the kernel's device time, held to its
    tolerance again, beside the plain version's, one `torch.matmul` call's
    (bf16 cuBLAS), the bound and the roofline share, at the plan's block
    geometry. Weights rotate through enough copies to exceed the 50 MB L2,
    as a step's do. Decode rows add the host's pace per kernel call; train
    rows add the TFLOPS and the backward's two fp32 `torch.matmul`s
    (`local_matmul`'s backward, run once per forward dispatch: half the
    step's launches, the other half being the remat recompute)."""
    g = torch.Generator(device=dev).manual_seed(seed)
    rows = []
    for (m, n, k), info in sorted(table.items()):
        block, count = info["block"], info["count"]
        a = torch.randn((m, k), generator=g, device=dev).to(torch.bfloat16)
        copies = max(1, math.ceil(120e6 / (k * n * 2)))
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
            fail(f"mmad at shape {m}x{n}x{k}: error {ratio:.2f}x its "
                 f"tolerance")
        err = float((got - want).abs().max())
        del got, want
        iters, warmup = (5, 1) if m * n * k > 1e11 else (20, 3)

        def timed(fn):
            return device_ms(torch, fn, iters=iters, warmup=warmup)

        kernel_ms = timed(lambda: mmad_mod.mmad(a, nxt(), block,
                                                torch.float32))
        flops = 2 * m * n * k
        t_bytes = (m * k * 2 + k * n * 2 + m * n * 4) / H100_BYTES_PER_S * 1e3
        t_ops = flops / H100_BF16_FLOPS * 1e3
        row = {"path": "train" if train else "decode", "shape": [m, n, k],
               "block": list(block), "launches_per_step": count,
               "kernel_ms": kernel_ms,
               "plain_ms": timed(lambda: ref.mmad_ref(a, nxt(),
                                                      torch.float32)),
               "library_ms": timed(lambda: torch.matmul(a, nxt())),
               "bound_ms": max(t_bytes, t_ops),
               "bound_by": "bytes" if t_bytes >= t_ops else "operations",
               "roofline_share": max(t_bytes, t_ops) / kernel_ms,
               "max_abs_err": err, "err_over_tolerance": ratio}
        if train:
            g32 = torch.randn((m, n), generator=g, device=dev)
            a32, b32 = a.float(), ws[0].float()
            row["kernel_tflops"] = flops / kernel_ms / 1e9
            row["backward_fp32_matmul_ms"] = timed(
                lambda: (torch.matmul(g32, b32.T), torch.matmul(a32.T, g32)))
            del g32, a32, b32
        else:
            row["kernel_call_wall_ms"] = wall_ms(
                torch, lambda: mmad_mod.mmad(a, nxt(), block, torch.float32))
        print(json.dumps(row), flush=True)
        rows.append(row)
        del a, ws
    torch.cuda.empty_cache()
    return rows


def busy_share(torch, params, cfg, planner, prompts, dev,
               unprofiled_step_ms: float, gemms_per_step: int) -> None:
    """Device busy time and wall time per decode step, both read from one
    window: the main run's batch, prompts and positions (prefill token by
    token through a fresh routed context, then its GEN decode steps under
    the profiler, the wall clock read inside the profiled window). Only
    device activity is traced: tracing every host op would slow the host,
    and with it the window, severalfold. Fails unless each of the step's
    `gemms_per_step` mmad calls ran as one kernel and none of them as the
    tile kernel's separate split-K reduce."""
    from repro_torch.launch import serve
    from repro_torch.models import shard_ctx
    from repro_torch.models.model import decode_init
    from repro_torch.train.steps import make_serve_step

    serve.install_gemm_context(planner, dev)
    step = make_serve_step(cfg)
    with torch.inference_mode():
        caches = decode_init(params, cfg, BATCH, PROMPT + GEN)
        for i in range(PROMPT):
            logits, caches = step(params, caches, prompts[:, i:i + 1], i)
        tok = torch.argmax(logits, -1)[:, None]
        with device_profile(torch, dev) as prof:
            t0 = time.perf_counter()
            for i in range(GEN):
                logits, caches = step(params, caches, tok, PROMPT + i)
                tok = torch.argmax(logits, -1)[:, None]
            serve._sync(dev)
            wall_ms = (time.perf_counter() - t0) * 1e3 / GEN
    shard_ctx.set_gemm_context(None)
    edges = edge_kernels_kept(torch, prof)
    kernels = device_kernels(torch, prof)
    busy_ms = sum(us for us, _, _ in kernels) / 1e3 / GEN
    reduce = [name for _, _, name in kernels if "mmad_splitk_reduce" in name]
    if reduce:
        fail(f"the decode window launched {reduce}")
    mmad_calls = sum(count for _, count, name in kernels if "mmad" in name)
    if mmad_calls != gemms_per_step * GEN:
        fail(f"{mmad_calls} mmad kernels ran in {GEN} decode steps of "
             f"{gemms_per_step} routed GEMMs")
    mmad_ms = sum(us for us, _, name in kernels if "mmad" in name) / 1e3 / GEN
    for us, count, name in kernels[:8]:
        print(f"  device {us / 1e3 / GEN:8.3f} ms/step  {count / GEN:7.1f} "
              f"calls/step  {name[:80]}", flush=True)
    print(f"profiled window of {GEN} decode steps (batch {BATCH}, positions "
          f"{PROMPT}-{PROMPT + GEN - 1}): device busy {busy_ms:.3f} ms per "
          f"step ({mmad_ms:.3f} ms in mmad) against {wall_ms:.3f} ms per "
          f"step wall in the same window: busy share {busy_ms / wall_ms:.1%}"
          f"; the rest is host time between launches (the unprofiled main "
          f"run took {unprofiled_step_ms:.3f} ms per step); the profile "
          f"kept {edges[0]} + {edges[1]} of its 2 x {PROFILE_EDGE_KERNELS} "
          f"edge kernels", flush=True)


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
               out["t_gen"] / GEN * 1e3, launches // (PROMPT + GEN))

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


def train_steps(torch, s, batch, dev, n: int):
    """`n` steps of the trainer's step function on one fixed batch from a
    fresh state (the launcher's seeded weights, zero moments). Returns the
    state, and per step the loss and grad norm it reports (both taken
    before its update) and its wall ms."""
    from repro_torch.launch import serve

    state = s.init_state()
    losses, norms, step_ms = [], [], []
    for _ in range(n):
        serve._sync(dev)
        t0 = time.perf_counter()
        state, m = s.step_fn(state, batch)
        serve._sync(dev)
        step_ms.append((time.perf_counter() - t0) * 1e3)
        losses.append(float(m["loss"]))
        norms.append(float(m["grad_norm"]))
    return state, losses, norms, step_ms


def check_trajectory(losses, norms, ref_losses, ref_norms) -> None:
    """The routed run's losses (before each step, then after the last) and
    grad norms against the unrouted run's: finite, within STEP0_REL at
    step 0 and LATER_*_REL after it, every step moving the loss the same
    way as in the unrouted run, and the loss ending below its start."""
    def rel(got, want):
        return [abs(x - y) / abs(y) for x, y in zip(got, want)]

    rel_loss, rel_norm = rel(losses, ref_losses), rel(norms, ref_norms)
    print(f"train trajectory on the fixed batch, routed vs unrouted: losses "
          f"{losses} vs {ref_losses} (rel {[f'{x:.2e}' for x in rel_loss]}; "
          f"tolerance {STEP0_REL} at step 0, {LATER_LOSS_REL} after); grad "
          f"norms {norms} vs {ref_norms} (rel "
          f"{[f'{x:.2e}' for x in rel_norm]}; tolerance {STEP0_REL} at step "
          f"0, {LATER_GNORM_REL} after)", flush=True)
    if not all(math.isfinite(x) for x in losses + norms):
        fail("non-finite loss or grad norm")
    if not (rel_loss[0] <= STEP0_REL and rel_norm[0] <= STEP0_REL):
        fail("routed step 0 differs from unrouted")
    if not (max(rel_loss[1:]) <= LATER_LOSS_REL
            and max(rel_norm[1:]) <= LATER_GNORM_REL):
        fail("the routed trajectory left the unrouted one")
    for i in range(len(losses) - 1):
        if ((losses[i + 1] > losses[i])
                != (ref_losses[i + 1] > ref_losses[i])):
            fail(f"step {i} moved the routed loss the other way than the "
                 f"unrouted one")
    if not losses[-1] < losses[0]:
        fail(f"loss did not fall: {losses[0]} -> {losses[-1]}")


def train_profile(torch, mmad_mod, s, state, batch, dev,
                  launches_per_step: int):
    """One more step under a device-only profile: busy and wall time from
    one window, and every mmad kernel must be the tile kernel (one per
    routed dispatch) or its split-K reduce."""
    with device_profile(torch, dev) as prof:
        t0 = time.perf_counter()
        state, _ = s.step_fn(state, batch)
        torch.cuda.synchronize(dev)
        wall_ms = (time.perf_counter() - t0) * 1e3
    edges = edge_kernels_kept(torch, prof)
    kernels = device_kernels(torch, prof)
    mmad = [(us, count, name) for us, count, name in kernels
            if "mmad" in name]
    other = [name for _, _, name in mmad if "mmad_tile_kernel" not in name
             and "mmad_splitk_reduce" not in name]
    if other:
        fail(f"the train step launched mmad kernels other than the tile "
             f"kernel: {other}")
    tiles = sum(count for _, count, name in mmad
                if "mmad_tile_kernel" in name)
    if tiles != launches_per_step:
        fail(f"{tiles} tile kernels ran in a step of {launches_per_step} "
             f"routed GEMM dispatches")
    busy_ms = sum(us for us, _, _ in kernels) / 1e3
    mmad_ms = sum(us for us, _, _ in mmad) / 1e3
    for us, count, name in kernels[:10]:
        print(f"  device {us / 1e3:9.3f} ms/step  {count:6d} calls/step  "
              f"{name[:80]}", flush=True)
    print(f"profiled train step: device busy {busy_ms:.3f} ms ({mmad_ms:.3f} "
          f"ms in mmad: {tiles} tile kernels + their split-K reduces) "
          f"against {wall_ms:.3f} ms wall in the same window: busy share "
          f"{busy_ms / wall_ms:.1%}; the profile kept {edges[0]} + "
          f"{edges[1]} of its 2 x {PROFILE_EDGE_KERNELS} edge kernels",
          flush=True)
    return {"busy_ms": busy_ms, "wall_ms": wall_ms, "mmad_ms": mmad_ms}


def resume_check(torch, dev):
    """The crash-resume loop on the card at smoke width: a failure injected
    at step 3, a checkpoint every 2 steps; the final state must equal an
    uninterrupted run's, bitwise."""
    from repro_torch.ckpt.manager import flatten
    from repro_torch.ft.runtime import FailureInjector
    from repro_torch.launch import train
    from repro_torch.models import shard_ctx
    from repro_torch.obs import set_tracer

    work = ROOT / "build" / "chip_smoke" / "resume"
    shutil.rmtree(work, ignore_errors=True)
    finals, injector = {}, FailureInjector(fail_at={3})
    for name, inj in (("clean", None), ("faulty", injector)):
        s = train.setup(train.parse_args([
            "--arch", "gemma-2b", "--smoke", "--device", dev.type,
            "--steps", "6", "--batch", "2", "--seq", "32", "--ckpt-every",
            "2", "--ckpt-dir", str(work / name), "--plan-cache",
            str(work / "plans")]))
        finals[name] = flatten(train.run(s, injector=inj))
        if s.gemm_ctx.stats.resolve_rate != 1.0:
            fail(f"smoke training resolve rate {s.gemm_ctx.stats.resolve_rate}")
        shard_ctx.set_gemm_context(None)
        set_tracer(None)
    if injector.failed != {3}:
        fail(f"the injected failure did not fire ({injector.failed})")
    diff = [name for (name, a), (_, b) in zip(finals["faulty"],
                                              finals["clean"])
            if not torch.equal(a, b)]
    if diff or len(finals["faulty"]) != len(finals["clean"]):
        fail(f"resumed run ended on other values than the uninterrupted "
             f"one: {diff[:5]}")
    shutil.rmtree(work, ignore_errors=True)
    print(f"resume at smoke width on {dev}: failure injected at step 3, "
          f"restored from the step-1 checkpoint; all "
          f"{len(finals['clean'])} state tensors equal an uninterrupted "
          f"6-step run's, bitwise", flush=True)


def train_gemma(torch, mmad_mod, dev, arch_args):
    """The train phase's main path: full-width gemma-2b (as `arch_args`
    name it), three routed steps on one fixed batch with per-layer remat.
    Returns the per-step launch count, the per-shape launch table and the
    numbers the report prints."""
    from repro_torch.kernels import ops
    from repro_torch.launch import serve, train
    from repro_torch.models import shard_ctx
    from repro_torch.obs import build_run_report, render_run_report, set_tracer
    from repro_torch.train import steps

    # the launcher's own setup: plan cache warmed for the train workload,
    # routing context and tracer installed, step function built
    t0 = time.perf_counter()
    plan_dir = ROOT / "build" / "chip_smoke" / "train_plans"
    shutil.rmtree(plan_dir, ignore_errors=True)
    s = train.setup(train.parse_args(
        arch_args + ["--steps", str(TRAIN_STEPS), "--lr", str(TRAIN_LR),
                     "--plan-cache", str(plan_dir)]))
    batch = s.batch_arrays(s.data.batch(0))
    print(f"train {s.cfg.name}: batch {s.args.batch} x seq {s.args.seq}, "
          f"lr {TRAIN_LR}, set up (plans warmed) in "
          f"{time.perf_counter() - t0:.2f}s", flush=True)

    # the yardstick: the same steps unrouted (x @ w, PyTorch's backward)
    shard_ctx.set_gemm_context(None)
    state, ref_losses, ref_norms, _ = train_steps(torch, s, batch, dev,
                                                  TRAIN_STEPS)
    with torch.no_grad():
        ref_losses.append(float(steps.loss_fn(state[0], batch, s.cfg)))
    del state
    torch.cuda.empty_cache()

    # the main path: a fresh routing context and state, counts from zero;
    # the tally records each mmad call's shape (the wrapper counts its
    # launches)
    ctx = serve.install_gemm_context(s.planner, dev)
    tally = {}
    real = ops.mmad

    def tallied(a, b, *args, **kw):
        key = (a.shape[0], b.shape[1], a.shape[1])
        tally[key] = tally.get(key, 0) + 1
        return real(a, b, *args, **kw)

    ops.mmad = tallied
    mmad_mod.reset_launch_count()
    try:
        state, losses, norms, step_ms = train_steps(torch, s, batch, dev,
                                                    TRAIN_STEPS)
    finally:
        ops.mmad = real
    launches = mmad_mod.launch_count()
    stats = ctx.stats
    executed = stats.executed_gemm
    report = build_run_report("train", stats=stats.to_dict(),
                              tracer=s.tracer,
                              extra={"arch": s.cfg.name,
                                     "steps": TRAIN_STEPS})
    for line in render_run_report(report):
        print(line, flush=True)
    params = state[0]
    print(f"{sum(p.numel() for p in params.parameters())} trainable "
          f"parameters + fp32 AdamW moments; step ms "
          f"{[round(t, 3) for t in step_ms]}", flush=True)
    with torch.no_grad():
        losses.append(float(steps.loss_fn(params, batch, s.cfg)))
    check_trajectory(losses, norms, ref_losses, ref_norms)
    if stats.resolve_rate != 1.0:
        fail(f"train plan-resolve rate {stats.resolve_rate}")
    if stats.silent_degrades:
        fail(f"{stats.silent_degrades} silent degrades in training")
    if launches == 0 or launches != executed:
        fail(f"mmad launched {launches} times for {executed} routed GEMM "
             f"dispatches in training")
    if sum(tally.values()) != launches or launches % TRAIN_STEPS:
        fail(f"per-shape tally {tally} does not add up to {launches}")
    per_step = launches // TRAIN_STEPS
    blocks = {(sh.m, sh.n, sh.k): ep.inner_kernel.geometry()
              for (_, sh), ep in ctx.resolved.items()
              if hasattr(sh, "m") and ep.inner_kernel is not None}
    table = {key: {"block": blocks[key], "count": n // TRAIN_STEPS}
             for key, n in tally.items()}

    prof = train_profile(torch, mmad_mod, s, state, batch, dev, per_step)
    shard_ctx.set_gemm_context(None)
    set_tracer(None)
    mean_ms = sum(step_ms[1:]) / len(step_ms[1:])
    tokens = s.args.batch * s.args.seq
    summary = {"step_ms": step_ms, "mean_step_ms": mean_ms,
               "tokens_per_s": tokens / mean_ms * 1e3, **prof}
    print(f"train {s.cfg.name} on {torch.cuda.get_device_name(dev) if dev.type == 'cuda' else dev}: "
          f"{mean_ms:.3f} ms per step (steps 1-{TRAIN_STEPS - 1}) = "
          f"{summary['tokens_per_s']:.1f} training tokens/s at batch "
          f"{s.args.batch} x seq {s.args.seq}; {per_step} mmad launches per "
          f"step = routed GEMM dispatches (forward + remat recompute), "
          f"resolve rate {stats.resolve_rate}", flush=True)
    del state, params
    return per_step, table, summary


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

    phase("train")
    train_launches, train_table, train_summary = train_gemma(
        torch, mmad_mod, dev,
        ["--arch", "gemma-2b", "--device", "cuda", "--batch",
         str(TRAIN_BATCH), "--seq", str(TRAIN_SEQ)])
    resume_check(torch, dev)

    # times below are per gemma-2b decode step at batch 4, and per train
    # step at batch 2 x seq 1024: the sum over the step's launches of each
    # shape's time
    phase("kernel timing")
    rows = time_shapes(torch, mmad_mod, ref, cfg, per_step, dev, SEED + 1)
    train_rows = time_shapes(torch, mmad_mod, ref, cfg, train_table, dev,
                             SEED + 2, train=True)

    def per_step_ms(key, rows=rows):
        return sum(r[key] * r["launches_per_step"] for r in rows)

    train_ms = per_step_ms("kernel_ms", train_rows)
    train_bound = per_step_ms("bound_ms", train_rows)
    train_library = per_step_ms("library_ms", train_rows)
    backward_ms = sum(r["backward_fp32_matmul_ms"] * r["launches_per_step"]
                      / 2 for r in train_rows)
    train_flops = sum(2 * math.prod(r["shape"]) * r["launches_per_step"]
                      for r in train_rows)
    print(f"train step (gemma-2b, batch {TRAIN_BATCH} x seq {TRAIN_SEQ}): "
          f"{train_summary['mean_step_ms']:.3f} ms = "
          f"{train_summary['tokens_per_s']:.1f} training tokens/s; mmad "
          f"{train_launches} launches, {train_flops / 1e12:.3f} TFLOP, "
          f"{train_ms:.3f} ms from the timed shapes "
          f"({train_summary['mmad_ms']:.3f} ms in the profiled step; "
          f"{train_flops / train_ms / 1e9:.1f} TFLOPS) against a bound of "
          f"{train_bound:.3f} ms (share {train_bound / train_ms:.1%}) and "
          f"torch.matmul's {train_library:.3f} ms; the backward's fp32 "
          f"torch.matmul {backward_ms:.3f} ms; device busy share "
          f"{train_summary['busy_ms'] / train_summary['wall_ms']:.1%}",
          flush=True)

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
        "train_launches": train_launches,
        "train_ms": train_ms,
        "train_plain_ms": per_step_ms("plain_ms", train_rows),
        "train_bound_ms": train_bound,
        "train_bound_by": ("bytes" if all(r["bound_by"] == "bytes"
                                          for r in train_rows)
                           else "operations"),
        "train_library_ms": train_library,
        "train_max_abs_err": max(r["max_abs_err"] for r in train_rows),
    }]}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
