"""Device time of `mmad` at gemma-2b's five train GEMMs (needs one H100).

    python3 tools/mmad_train_times.py [--root DIR] [--repeats N]
                                      [--both-majors] [--simt] [--ptxas]

Imports `repro_torch` from DIR/src (default: this checkout), so one card
can time two trees of the port in turn (parent, change, change, parent).
Per train shape (batch 2 x seq 1024; the lm_head loss chunk reads
`embed.T`) it prints one JSON line: the route `plan_launch` picks, the
kernel's device time per call over N repeats (median, min, max; CUDA
events around calls queued behind a spin kernel, weights rotated past the
L2, as `chip_smoke.py` times them) and its TFLOPS, one `torch.matmul`
call's median, the plain version's, the bound (operations or bytes, as
`chip_smoke.py` computes it), the kernel's error against the plain version
over the IEEE bound and over the bound its variant is held to, and
whether three launches agree bit for bit.

--both-majors adds each shape with B in the other major (a (K, N) weight
for the lm_head, a K-contiguous view for the rest); --simt also times the
SIMT tile kernel on the same operands (the route every train GEMM took
before the tensor-core variant; `wgmma_b_major` is switched off for it);
--ptxas first builds the library once more with `-Xptxas -v` and prints
the tensor-core kernels' register and spill report. Prints the card's
name and power limit first.
"""
from __future__ import annotations

import argparse
import importlib
import json
import math
import statistics
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]

# (m, n, k), the plan's block geometry, B K-contiguous (embed.T) on the
# train path, launches per train step
SHAPES = [
    ((2048, 2048, 2048), (512, 512, 512), False, 72),     # q, o
    ((2048, 256, 2048), (128, 256, 512), False, 72),      # k, v
    ((2048, 16384, 2048), (512, 512, 512), False, 72),    # gate, up
    ((2048, 2048, 16384), (512, 512, 512), False, 36),    # down
    ((1024, 256000, 2048), (512, 128, 512), True, 4),     # lm_head chunk
]


def ptxas_report(build) -> None:
    """Compile csrc/mmad.cu with the ptxas report into build/ and print the
    tensor-core kernels' part of it."""
    out = build.build_dir() / "ptxas_report.so"
    out.parent.mkdir(parents=True, exist_ok=True)
    cmd = [build.find_nvcc(), *build.NVCC_FLAGS, "-Xptxas", "-v", "-o",
           str(out), str(build.CSRC / "mmad.cu")]
    lines = subprocess.run(cmd, capture_output=True, text=True,
                           check=True).stderr.splitlines()
    for i, line in enumerate(lines):
        if "Compiling entry function" in line and "wgmma" in line:
            print("\n".join(lines[i:i + 4]), flush=True)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", type=Path, default=ROOT)
    ap.add_argument("--repeats", type=int, default=3)
    ap.add_argument("--both-majors", action="store_true")
    ap.add_argument("--simt", action="store_true")
    ap.add_argument("--ptxas", action="store_true")
    args = ap.parse_args()
    sys.path.insert(0, str(ROOT))
    import chip_smoke as cs                      # timing helpers, this tree's
    sys.path.insert(0, str(args.root.resolve() / "src"))
    import torch
    mm = importlib.import_module("repro_torch.kernels.mmad")
    from repro_torch.kernels import build, ref

    if not torch.cuda.is_available():
        cs.fail("no CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    print(cs.smi_line(), flush=True)
    if args.ptxas:
        ptxas_report(build)
    dev = torch.device("cuda")
    n_sms = torch.cuda.get_device_properties(dev).multi_processor_count
    g = torch.Generator(device=dev).manual_seed(cs.SEED + 2)
    cases = [(shape, block, tb, count, tb) for shape, block, tb, count
             in SHAPES]
    if args.both_majors:
        cases += [(shape, block, not tb, count, tb) for shape, block, tb,
                  count in SHAPES]
    for (m, n, k), block, tb, count, main_path in cases:
        a = torch.randn((m, k), generator=g, device=dev).to(torch.bfloat16)
        copies = max(1, math.ceil(120e6 / (k * n * 2)))
        ws = [(torch.randn((n, k), generator=g, device=dev).T if tb
               else torch.randn((k, n), generator=g, device=dev))
              .to(torch.bfloat16) for _ in range(copies)]
        it = {"i": 0}

        def nxt():
            it["i"] = (it["i"] + 1) % copies
            return ws[it["i"]]

        variant = mm.plan_launch(m, n, k, None, n_sms, mm.b_layout(ws[0]),
                                 2, mm.wgmma_b_major(a, ws[0]))[0]
        got = mm.mmad(a, ws[0], out_dtype=torch.float32)
        want = ref.mmad_ref(a, ws[0], torch.float32)
        repeats = all(torch.equal(mm.mmad(a, ws[0], out_dtype=torch.float32),
                                  got) for _ in range(2))
        iters, warmup = (5, 1) if m * n * k > 1e11 else (20, 3)

        def times(fn):
            return [1e3 * cs.device_ms(torch, fn, iters=iters, warmup=warmup)
                    for _ in range(args.repeats)]

        kernel = times(lambda: mm.mmad(a, nxt(), out_dtype=torch.float32))
        flops = 2 * m * n * k
        t_bytes = (m * k * 2 + k * n * 2 + m * n * 4) / cs.H100_BYTES_PER_S
        t_ops = flops / cs.H100_BF16_FLOPS
        row = {
            "root": str(args.root), "shape": [m, n, k],
            "b": "k-contiguous" if tb else "n-contiguous",
            "main_path": tb == main_path, "launches_per_step": count,
            "variant": variant, "kernel_us": statistics.median(kernel),
            "kernel_us_min": min(kernel), "kernel_us_max": max(kernel),
            "kernel_tflops": flops / statistics.median(kernel) / 1e6,
            "matmul_us": statistics.median(
                times(lambda: torch.matmul(a, nxt()))),
            "plain_us": statistics.median(
                times(lambda: ref.mmad_ref(a, nxt(), torch.float32))),
            "bound_us": 1e6 * max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "err_over_ieee_tolerance": cs.tolerance_ratio(
                torch, got, want, k, torch.float32),
            "err_over_tolerance": cs.tolerance_ratio(
                torch, got, want, k, torch.float32, variant == mm.WGMMA),
            "max_abs_err": float((got - want).abs().max()),
            "three_launches_bitwise_equal": repeats}
        if args.simt:
            real = mm.wgmma_b_major
            mm.wgmma_b_major = lambda *_: None
            try:
                simt = times(lambda: mm.mmad(a, nxt(), out_dtype=torch.float32))
            finally:
                mm.wgmma_b_major = real
            row["simt_tile_us"] = statistics.median(simt)
        print(json.dumps(row), flush=True)
        del ws, a, got, want
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
