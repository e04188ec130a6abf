"""Instance configurations of `mmad`'s SIMT tile kernel, timed side by side
(needs one H100).

    python3 tools/mmad_tile_sweep.py [--only NAME ...]

Builds copies of `csrc/mmad.cu` under `build/tile_sweep/`, each with rows
of the `TILE_CFGS` table replaced (and, for the probes, the stage loop
cut to its copies alone or its sums alone), all `nvcc`s at once, then
launches each copy's instance directly through its `mmad_launch` at the
given K split (the split `tile_geometry` would pick is bypassed) and prints
one JSON line a case: its device time per call (median of three
`chip_smoke.device_ms` readings: CUDA events around calls queued behind a
spin kernel, weights rotated past the L2), its CTAs, its error over the
IEEE tolerance (meaningless for the probes) and whether its counters are
left at zero. Then fp32 `torch.matmul` at each shape. Prints the card's
name and power limit first.

The table below holds the comparisons behind the instance table: for the
train router (2048 x 2048 -> 64) and the gates (2048 x 2048 -> 8), the
resident CTAs an SM is asked for (`__launch_bounds__`, hence the
register cap) and the K split; the wide instance's register cap; a
128-row router tile and a 4 x 8 register block; rings of 6 and 8 stages;
for the router and the wide record shape (2048^3), the copies alone
("loads") and the sums alone ("sums"), which bound the stage loop from
either side, and the sums without B's or A's shared-memory reads or
without both (only the FMAs and the barriers); and an unsplit K = 32
call, one stage, which is the call's fixed cost.
"""
from __future__ import annotations

import argparse
import ctypes
import importlib
import json
import math
import re
import statistics
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "src"))

LOADS = [("      cp_async_commit();\n      compute(it);",
          "      cp_async_commit();\n      if (it < 0) compute(it);")]
SUMS = [("      if (s < nk) issue(s);", "      if (s < 0) issue(s);"),
        ("      if (it + STAGES - 1 < nk) issue(it + STAGES - 1);",
         "      if (it < 0) issue(it);")]
NO_A = [("ld4<SA>(as + i * RY * L::A_PITCH + kq * sizeof(SA), a[i]);",
         "for (int e = 0; e < 4; ++e) a[i][e] = 1.f + i + e;")]
NO_B = [("ld4<SB>(bs + (kq + kk) * L::B_PITCH + j * TX * 4 * sizeof(SB), b + 4 * j);",
         "for (int e = 0; e < 4; ++e) b[4 * j + e] = 0.5f + kk + e;")]
NARROW64, NARROW8, WIDE = 4, 1, 5
ROUTER, GATES, RECORD = (2048, 64, 2048), (2048, 8, 2048), (2048, 2048, 2048)
# name -> (instance code -> TILE_CFGS row (bm, bn, tm, tn, ks, stages,
# min_ctas), source edits, cases: (instance code, (m, n, k), splits))
VARIANTS = {
    "two_ctas": ({NARROW64: (64, 64, 8, 8, 4, 4, 2),
                  WIDE: (128, 128, 8, 8, 1, 3, 2),
                  NARROW8: (64, 8, 1, 8, 4, 4, 4)}, [],
                 [(NARROW64, ROUTER, 4), (NARROW64, ROUTER, 8),
                  (WIDE, RECORD, 1), (NARROW8, GATES, 4),
                  (NARROW8, GATES, 8), (NARROW8, GATES, 16)]),
    "one_cta": ({NARROW64: (64, 64, 8, 8, 4, 4, 1),
                 WIDE: (128, 128, 8, 8, 1, 3, 1)}, [],
                [(NARROW64, ROUTER, 4), (NARROW64, ROUTER, 8),
                 (NARROW64, (2048, 64, 32), 1), (WIDE, RECORD, 1)]),
    "one_cta_loads": ({NARROW64: (64, 64, 8, 8, 4, 4, 1),
                       WIDE: (128, 128, 8, 8, 1, 3, 1)}, LOADS,
                      [(NARROW64, ROUTER, 4), (WIDE, RECORD, 1)]),
    "one_cta_sums": ({NARROW64: (64, 64, 8, 8, 4, 4, 1),
                      WIDE: (128, 128, 8, 8, 1, 3, 1)}, SUMS,
                     [(NARROW64, ROUTER, 4), (WIDE, RECORD, 1)]),
    "tall_router": ({NARROW64: (128, 64, 8, 8, 2, 4, 1)}, [],
                    [(NARROW64, ROUTER, 4), (NARROW64, ROUTER, 8)]),
    "router_4x8": ({NARROW64: (64, 64, 4, 8, 2, 4, 2)}, [],
                   [(NARROW64, ROUTER, 4), (NARROW64, ROUTER, 8)]),
    "sums_no_b": ({NARROW64: (64, 64, 8, 8, 4, 4, 1)}, SUMS + NO_B,
                  [(NARROW64, ROUTER, 4)]),
    "sums_no_a": ({NARROW64: (64, 64, 8, 8, 4, 4, 1)}, SUMS + NO_A,
                  [(NARROW64, ROUTER, 4)]),
    "fmas_only": ({NARROW64: (64, 64, 8, 8, 4, 4, 1)}, SUMS + NO_A + NO_B,
                  [(NARROW64, ROUTER, 4)]),
    "deep_rings": ({NARROW64: (64, 64, 8, 8, 4, 8, 1),
                    NARROW8: (64, 8, 1, 8, 4, 8, 2)}, [],
                   [(NARROW64, ROUTER, 4), (NARROW8, GATES, 8)]),
    "six_stages": ({NARROW64: (64, 64, 8, 8, 4, 6, 1),
                    NARROW8: (64, 8, 1, 8, 4, 6, 2)}, [],
                   [(NARROW64, ROUTER, 4), (NARROW8, GATES, 8)]),
}


def source(rows: dict, edits) -> str:
    """csrc/mmad.cu with TILE_CFGS rows replaced by instance code."""
    from repro_torch.kernels import build
    src = (build.CSRC / "mmad.cu").read_text()
    head = src.index("constexpr TileCfg TILE_CFGS[] = {")
    table = src[head:src.index("};", head)]
    found = re.findall(r"\{\d+, \d+, \d+, \d+, \d+, \d+, \d+\}", table)
    new = table
    for code, row in rows.items():
        new = new.replace(found[code], "{" + ", ".join(map(str, row)) + "}",
                          1)
    src = src.replace(table, new)
    for old, repl in edits:
        if old not in src:
            raise SystemExit(f"probe edit no longer applies: {old!r}")
        src = src.replace(old, repl)
    return src


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--only", nargs="*", default=None)
    args = ap.parse_args()
    import torch
    import chip_smoke as cs
    mm = importlib.import_module("repro_torch.kernels.mmad")
    from repro_torch.kernels import build, ref

    if not torch.cuda.is_available():
        cs.fail("no CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    print(cs.smi_line(), flush=True)
    names = args.only or list(VARIANTS)
    out = build.build_dir().parent / "tile_sweep"
    out.mkdir(parents=True, exist_ok=True)
    procs = {}
    for name in names:
        rows, edits, _ = VARIANTS[name]
        cu = out / f"{name}.cu"
        cu.write_text(source(rows, edits))
        procs[name] = subprocess.Popen(
            [build.find_nvcc(), *build.NVCC_FLAGS, "-o",
             str(out / f"lib{name}.so"), str(cu)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    for name, proc in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise SystemExit(f"nvcc failed on {name}:\n{log[-4000:]}")
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(cs.SEED + 5)
    shapes = sorted({shape for n in names for _, shape, _ in VARIANTS[n][2]})
    ops = {}
    for m, n, k in shapes:
        a = torch.randn((m, k), generator=g, device=dev)
        copies = max(1, math.ceil(120e6 / (k * n * 4)))
        ws = [torch.randn((k, n), generator=g, device=dev)
              for _ in range(copies)]
        ops[(m, n, k)] = (a, ws, ref.mmad_ref(a, ws[0], torch.float32))
    stream = torch.cuda.current_stream(dev).cuda_stream
    counters = torch.zeros(4096, dtype=torch.int32, device=dev)
    scratch = torch.empty(16 << 20, dtype=torch.float32, device=dev)
    for name in names:
        rows, _, cases = VARIANTS[name]
        lib = mm.bind(ctypes.CDLL(str(out / f"lib{name}.so")))
        for code, (m, n, k), want_splits in cases:
            bm, bn = rows[code][:2]
            a, ws, want = ops[(m, n, k)]
            kps = math.ceil(k / want_splits / mm.TILE_BK) * mm.TILE_BK
            splits = math.ceil(k / kps)
            c = torch.empty((m, n), device=dev)
            it = {"i": 0}

            def launch(b=None):
                it["i"] = (it["i"] + 1) % len(ws)
                b = ws[it["i"]] if b is None else b
                err = lib.mmad_launch(
                    a.data_ptr(), b.data_ptr(), c.data_ptr(),
                    scratch.data_ptr(), counters.data_ptr(), 0, 0, 0, m, n, k,
                    a.stride(0), 1, b.stride(0), 1, kps, splits, mm.TILE,
                    code, stream)
                if err:
                    cs.fail(f"{name} code {code}: cudaError {err}")

            launch(ws[0])
            torch.cuda.synchronize()
            ratio = cs.tolerance_ratio(torch, c, want, k, torch.float32)
            us = [1e3 * cs.device_ms(torch, launch) for _ in range(3)]
            print(json.dumps({
                "variant": name, "instance_code": code, "row": rows[code],
                "shape": [m, n, k], "splits": splits, "kps": kps,
                "ctas": math.ceil(m / bm) * math.ceil(n / bn) * splits,
                "us": statistics.median(us), "us_min": min(us),
                "err_over_tolerance": ratio,
                "counters_zero": int(counters.abs().sum()) == 0}),
                flush=True)
    for m, n, k in shapes:
        a, ws, _ = ops[(m, n, k)]
        it = {"i": 0}

        def matmul():
            it["i"] = (it["i"] + 1) % len(ws)
            torch.matmul(a, ws[it["i"]])

        print(json.dumps({"shape": [m, n, k], "fp32_matmul_us": 1e3 *
                          cs.device_ms(torch, matmul)}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
