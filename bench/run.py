"""Run one benchmark cell once on the card and print its result line.

    python3 bench/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

Run from the root of a checkout. The cell is `bench/workloads/<cell>.json`;
`BENCHMARK.json` names the metrics it reports. Without a CUDA card, or with
fewer cards than the cell asks for, it exits non-zero and prints no result.
"""
from __future__ import annotations

import argparse
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT), str(ROOT / "src")]

from bench.harness import core, runner  # noqa: E402


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    cell = core.load_json("workloads", args.workload)

    import torch
    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < int(cell["chips"]):
        have = torch.cuda.device_count() if torch.cuda.is_available() else 0
        print(f"bench: {args.workload} needs {cell['chips']} CUDA card(s); "
              f"this host has {have}", file=sys.stderr)
        return 2
    runner.execute(args.workload, args.seed, args.seconds, bool(args.trace),
                   cell=cell)
    return 0


if __name__ == "__main__":
    sys.exit(main())
