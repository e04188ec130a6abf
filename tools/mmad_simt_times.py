"""Device time of `mmad`'s SIMT tile route at its main-path and record
shapes (needs one H100).

    python3 tools/mmad_simt_times.py [--root DIR] [--repeats N] [--ptxas]

Imports `repro_torch` from DIR/src (default: this checkout), so one card
can time two trees of the port in turn (parent, change, change, parent).
Per shape it prints one JSON line: the route and, where the tree has
`tile_geometry`, the instance, grid and split; the kernel's device time per
call over N repeats (median, min, max; CUDA events around calls queued
behind a spin kernel, weights rotated past the L2, as `chip_smoke.py`
times them); one `torch.matmul` call's median (fp32; for fp8 e4m3
`torch._scaled_mm` with unit scales, fp32 out, or null where the card's
torch refuses it); the plain version's; the bound (bytes over 3.35 TB/s or
operations over the operands' peak, as `chip_smoke.py` computes it); the
error against the plain version over the IEEE tolerance; whether three
launches agree bit for bit; and whether the split counters are zero after.

The shapes: deepseek-moe-16b's fp32 router in training (2048 x 2048 ->
64), xlstm-1.3b's fp32 gates in training (2048 x 2048 -> 8) and in a
512-token forward, and two record shapes, fp32 and fp8 e4m3 at 2048 x 2048
-> 2048 (fp32 out). --ptxas first builds the library once more with
`-Xptxas -v` and prints the tile kernels' register and spill report.
Prints the card's name and power limit first.
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

# (name, (m, n, k), dtype name, the plan's block, launches per train step):
# the router's and gates' blocks are their train plans' (batch 2 x seq
# 1024, the plan cache warmed as `launch.train.warm_train_plans` does); a
# tree whose tile kernel splits K in plan-bk blocks reads them
SHAPES = [
    ("moe.router train", (2048, 64, 2048), "float32", (512, 64, 512), 6),
    ("mlstm.gates train", (2048, 8, 2048), "float32", (512, 8, 512), 28),
    ("mlstm.gates forward", (512, 8, 2048), "float32", (128, 8, 512), 0),
    ("record fp32", (2048, 2048, 2048), "float32", (128, 128, 128), 0),
    ("record fp8", (2048, 2048, 2048), "float8_e4m3fn", (128, 128, 128), 0),
]


def ptxas_report(build) -> None:
    """Compile csrc/mmad.cu with the ptxas report into build/ and print the
    tile kernels' part of it."""
    out = build.build_dir() / "ptxas_report.so"
    out.parent.mkdir(parents=True, exist_ok=True)
    cmd = [build.find_nvcc(), *build.NVCC_FLAGS, "-Xptxas", "-v", "-o",
           str(out), str(build.CSRC / "mmad.cu")]
    lines = subprocess.run(cmd, capture_output=True, text=True,
                           check=True).stderr.splitlines()
    for i, line in enumerate(lines):
        if "Compiling entry function" in line and "tile" in line:
            print("\n".join(lines[i:i + 4]), flush=True)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", type=Path, default=ROOT)
    ap.add_argument("--repeats", type=int, default=3)
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
    g = torch.Generator(device=dev).manual_seed(cs.SEED + 3)
    for name, (m, n, k), dtype_name, block, count in SHAPES:
        dtype = getattr(torch, dtype_name)
        size = dtype.itemsize
        a = torch.randn((m, k), generator=g, device=dev).to(dtype)
        copies = max(1, math.ceil(120e6 / (k * n * size)))
        ws = [torch.randn((k, n), generator=g, device=dev).to(dtype)
              for _ in range(copies)]
        it = {"i": 0}

        def nxt():
            it["i"] = (it["i"] + 1) % copies
            return ws[it["i"]]

        route = [m, n, k, None, n_sms, mm.b_layout(ws[0]), size,
                 mm.wgmma_b_major(a, ws[0])]
        row = {"root": str(args.root), "name": name, "shape": [m, n, k],
               "dtype": dtype_name, "launches_per_step": count}
        if hasattr(mm, "tile_geometry"):
            vector = mm.tile_vectors(a, ws[0])
            route.append(vector)
            geo = mm.tile_geometry(m, n, k, size, size, n_sms, vector)
            row.update(instance=geo.instance, grid=list(geo.grid))
        row["variant"], row["kps"], row["splits"] = mm.plan_launch(*route)
        got = mm.mmad(a, ws[0], out_dtype=torch.float32)
        want = ref.mmad_ref(a, ws[0], torch.float32)
        repeats = all(torch.equal(mm.mmad(a, ws[0], out_dtype=torch.float32),
                                  got) for _ in range(2))
        torch.cuda.synchronize()
        counters = [int(buf.abs().sum()) for buf in mm._counters.values()]

        def times(fn):
            return [1e3 * cs.device_ms(torch, fn) for _ in range(args.repeats)]

        kernel = times(lambda: mm.mmad(a, nxt(), out_dtype=torch.float32))
        if dtype == torch.float8_e4m3fn:
            one = torch.ones((), device=dev)
            cols = [w.T.contiguous().T for w in ws]     # B column-major

            def scaled():
                it["i"] = (it["i"] + 1) % copies
                return torch._scaled_mm(a, cols[it["i"]], one, one,
                                        out_dtype=torch.float32)
            try:
                scaled()
                library = statistics.median(times(scaled))
            except (RuntimeError, TypeError) as err:
                library = None
                row["library_refused"] = str(err).splitlines()[0][:200]
            peak = cs.H100_FP8_FLOPS
        else:
            library = statistics.median(times(lambda: torch.matmul(a, nxt())))
            peak = cs.H100_FP32_FLOPS
        t_bytes = ((m * k + k * n) * size + m * n * 4) / cs.H100_BYTES_PER_S
        t_ops = 2 * m * n * k / peak
        row.update(
            kernel_us=statistics.median(kernel), kernel_us_min=min(kernel),
            kernel_us_max=max(kernel), matmul_us=library,
            plain_us=statistics.median(times(
                lambda: ref.mmad_ref(a, nxt(), torch.float32))),
            bound_us=1e6 * max(t_bytes, t_ops),
            bound_by="bytes" if t_bytes >= t_ops else "operations",
            err_over_tolerance=cs.tolerance_ratio(torch, got, want, k,
                                                  torch.float32),
            max_abs_err=float((got - want).abs().max()),
            three_launches_bitwise_equal=repeats,
            counters_zero=not any(counters))
        row["roofline_share"] = row["bound_us"] / row["kernel_us"]
        print(json.dumps(row), flush=True)
        del ws, a, got, want
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
