"""Device time of `mmad` at gemma-2b's five decode GEMMs (needs one H100).

    python3 tools/mmad_decode_times.py [--root DIR] [--repeats N]

Imports `repro_torch` from DIR/src (default: this checkout), so one card
can time two trees of the port in turn: run it once per tree, alternating
(parent, change, change, parent), and compare within the call. Each tree
builds its kernels into its own `build/`. Per shape it prints one JSON
line: the kernel's device time per call over N repeats (median, min, max;
CUDA events around 20 calls queued behind a spin kernel, weights rotated
past the L2, as `chip_smoke.py` times them), one `torch.matmul` call's
median, and the kernel's error against the plain version over its
tolerance. Prints the card's name and power limit first.
"""
from __future__ import annotations

import argparse
import importlib
import json
import math
import statistics
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]

# (m, n, k), plan block geometry, B transposed (the tied lm_head's embed.T)
SHAPES = [
    ((4, 2048, 2048), (4, 128, 256), False),     # q, o
    ((4, 256, 2048), (4, 256, 128), False),      # k, v
    ((4, 16384, 2048), (4, 512, 256), False),    # gate, up
    ((4, 2048, 16384), (4, 128, 512), False),    # down
    ((4, 256000, 2048), (4, 512, 256), True),    # lm_head
]


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", type=Path, default=ROOT)
    ap.add_argument("--repeats", type=int, default=5)
    args = ap.parse_args()
    sys.path.insert(0, str(ROOT))
    import chip_smoke as cs                      # timing helpers, this tree's
    sys.path.insert(0, str(args.root.resolve() / "src"))
    import torch
    mm = importlib.import_module("repro_torch.kernels.mmad")
    from repro_torch.kernels import ref

    if not torch.cuda.is_available():
        cs.fail("no CUDA device")
    print(cs.smi_line(), flush=True)
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(cs.SEED + 1)
    for (m, n, k), block, tb in SHAPES:
        a = torch.randn((m, k), generator=g, device=dev).to(torch.bfloat16)
        copies = max(1, math.ceil(120e6 / (k * n * 2)))
        ws = [(torch.randn((n, k), generator=g, device=dev).T if tb
               else torch.randn((k, n), generator=g, device=dev))
              .to(torch.bfloat16) for _ in range(copies)]
        it = {"i": 0}

        def nxt():
            it["i"] = (it["i"] + 1) % copies
            return ws[it["i"]]

        got = mm.mmad(a, ws[0], out_dtype=torch.float32)
        ratio = cs.tolerance_ratio(torch, got, ref.mmad_ref(a, ws[0],
                                                             torch.float32),
                                   k, torch.float32)
        kernel = [1e3 * cs.device_ms(
            torch, lambda: mm.mmad(a, nxt(), out_dtype=torch.float32))
            for _ in range(args.repeats)]
        library = [1e3 * cs.device_ms(torch, lambda: torch.matmul(a, nxt()))
                   for _ in range(args.repeats)]
        print(json.dumps({
            "root": str(args.root), "shape": [m, n, k],
            "kernel_us": statistics.median(kernel),
            "kernel_us_min": min(kernel), "kernel_us_max": max(kernel),
            "matmul_us": statistics.median(library),
            "err_over_tolerance": ratio}), flush=True)
        del ws, a, got
    return 0


if __name__ == "__main__":
    sys.exit(main())
