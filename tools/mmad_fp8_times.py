"""Device time and error of `mmad` on fp8 e4m3 operands at the paper's
DeepGEMM shapes (needs one H100).

    python3 tools/mmad_fp8_times.py [--root DIR] [--repeats N] [--ptxas]
                                    [--skip-errors] [--skip-times]

Imports `repro_torch` from DIR/src (default: this checkout), so one card
can time two trees of the port in turn (parent, change, change, parent).
Prints the card's name and power limit first, then JSON lines:

- `errors`: the fp8 tensor-core route's largest error against the plain
  version (IEEE fp32 sums of the exact products) at K = 512, 2048, 7168
  and 16384 (M = N = 1536: 144 output tiles, so K is not split), with the
  tensor-core sums promoted into fp32 every K step (`FP8_PROMOTE_STEPS` =
  1, 128 k), every 4, and never (once at the end), beside `chip_smoke.py`'s
  `fp8_tensor_core_atol` for the route: the readings behind the promotion
  decision and the tolerance;
- one line per shape: the 18 paper shapes (M = 4096, 64 and 128 against
  the six DeepSeek-V3 (N, K) of `chip_smoke.DEEPGEMM_NK`) and the 2048^3
  record, fp32 out, each with the route, grid and split the tree's
  geometry gives, the kernel's device time per call for an N-major B (a
  (K, N) weight: the call transposes it first) and a K-major B (`w.T` of an
  (N, K) weight), medians of N repeats (CUDA events around calls queued
  behind a spin kernel, weights rotated past the L2, as `chip_smoke.py`
  times them), `torch._scaled_mm` with unit scales and a K-major B (null
  where the card's torch refuses it), the plain version, the bound (bytes
  over 3.35 TB/s or operations over the fp8 peak, whichever is larger),
  the roofline share of each B major, the error over the route's
  tolerance, whether three launches agree bit for bit and whether the
  split counters are zero after.

--split-sweep times the 12 flat shapes (one M tile) with a K-major B at
each K split count the route could take (the SM count it is given scaled
so `fp8_geometry` picks that count): the readings behind the split rule.
--ptxas first builds the library once more with `-Xptxas -v` and prints
the fp8 kernels' register and spill report.
"""
from __future__ import annotations

import argparse
import importlib
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
ERROR_KS = (512, 2048, 7168, 16384)
ERROR_MN = 1536
PROMOTIONS = (1, 4, 0)


def ptxas_report(build) -> None:
    """Compile csrc/mmad.cu with the ptxas report into build/ and print the
    fp8 kernels' part of it."""
    out = build.build_dir() / "ptxas_report.so"
    out.parent.mkdir(parents=True, exist_ok=True)
    cmd = [build.find_nvcc(), *build.NVCC_FLAGS, "-Xptxas", "-v", "-o",
           str(out), str(build.CSRC / "mmad.cu")]
    lines = subprocess.run(cmd, capture_output=True, text=True,
                           check=True).stderr.splitlines()
    for i, line in enumerate(lines):
        if "Compiling entry function" in line and "fp8" in line:
            print("\n".join(lines[i:i + 4]), flush=True)


def errors(torch, cs, mm, ref, dev) -> None:
    """The route's error against the plain version by K and promotion."""
    g = torch.Generator(device=dev).manual_seed(cs.SEED + 51)
    keep = mm.FP8_PROMOTE_STEPS
    try:
        for k in ERROR_KS:
            a = torch.randn((ERROR_MN, k), generator=g,
                            device=dev).to(torch.float8_e4m3fn)
            b = torch.randn((k, ERROR_MN), generator=g,
                            device=dev).to(torch.float8_e4m3fn)
            want = ref.mmad_ref(a, b, torch.float32)
            row = {"errors": True, "m": ERROR_MN, "n": ERROR_MN, "k": k,
                   "variant": mm.plan_launch(
                       ERROR_MN, ERROR_MN, k, None,
                       mm._num_sms(dev), mm.b_layout(b), 1,
                       mm.wgmma_b_major(a, b))[:3],
                   "max_abs_want": float(want.abs().max())}
            for steps in PROMOTIONS:
                mm.FP8_PROMOTE_STEPS = steps
                got = mm.mmad(a, b, out_dtype=torch.float32)
                err = (got - want).abs()
                row[f"promote_{steps}"] = {
                    "max_abs_err": float(err.max()),
                    "rms_err": float(err.square().mean().sqrt()),
                    "max_rel_err": float((err / want.abs().clamp_min(1))
                                         .max())}
            if hasattr(cs, "fp8_tensor_core_atol"):
                row["fp8_tensor_core_atol"] = cs.fp8_tensor_core_atol(k)
            print(json.dumps(row), flush=True)
            del a, b, want, got, err
    finally:
        mm.FP8_PROMOTE_STEPS = keep
    torch.cuda.empty_cache()


def times(torch, cs, mm, ref, dev, repeats: int) -> None:
    """The 18 paper shapes and the record, one JSON line each
    (`chip_smoke.time_fp8_shapes`)."""
    shapes = ([(m, n, k) for m in (4096, 64, 128) for n, k in cs.DEEPGEMM_NK]
              + [cs.FP8_RECORD])
    for shape in shapes:
        row, = cs.time_fp8_shapes(torch, mm, ref, dev, cs.SEED + 52,
                                  [shape], repeats)
        print(json.dumps(row), flush=True)


def split_sweep(torch, cs, mm, dev, repeats: int) -> None:
    """K-major flat shapes at each split count: µs per call by splits."""
    g = torch.Generator(device=dev).manual_seed(cs.SEED + 55)
    f8 = torch.float8_e4m3fn
    num_sms = mm._num_sms
    try:
        for m in (64, 128):
            for n, k in cs.DEEPGEMM_NK:
                a = torch.randn((m, k), generator=g, device=dev).to(f8)
                copies = max(1, -(-120_000_000 // (k * n)))
                ws = [torch.randn((n, k), generator=g, device=dev).to(f8).T
                      for _ in range(copies)]
                it = {"i": 0}

                def call():
                    it["i"] = (it["i"] + 1) % copies
                    return mm.mmad(a, ws[it["i"]], out_dtype=torch.float32)
                tiles = -(-n // mm.FP8_BN_FLAT)
                steps = -(-k // mm.FP8_BK)
                row = {"split_sweep": [m, n, k]}
                for want in (1, 2, 3, 4, 5, 6, 7, 8, 10, 12, 16):
                    if want > steps:
                        break
                    mm._num_sms = lambda _dev, s=want: s * tiles
                    splits = mm.fp8_geometry(m, n, k, "k",
                                             want * tiles).splits
                    if str(splits) in row:
                        continue
                    row[str(splits)] = sorted(
                        1e3 * cs.device_ms(torch, call, iters=20, warmup=2)
                        for _ in range(repeats))[repeats // 2]
                mm._num_sms = num_sms
                print(json.dumps(row), flush=True)
                del a, ws
    finally:
        mm._num_sms = num_sms
    torch.cuda.empty_cache()


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", type=Path, default=ROOT)
    ap.add_argument("--repeats", type=int, default=3)
    ap.add_argument("--ptxas", action="store_true")
    ap.add_argument("--skip-errors", action="store_true")
    ap.add_argument("--skip-times", action="store_true")
    ap.add_argument("--split-sweep", action="store_true")
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
    if not args.skip_errors and hasattr(mm, "WGMMA_FP8"):
        errors(torch, cs, mm, ref, dev)
    if not args.skip_times:
        times(torch, cs, mm, ref, dev, args.repeats)
    if args.split_sweep:
        split_sweep(torch, cs, mm, dev, args.repeats)
    return 0


if __name__ == "__main__":
    sys.exit(main())
