"""Readings that set a cell's correctness limits: the numbers a run
compares, read through the harness's own run (`runner.execute`) on each
seed for the program, and on some seeds with the timed path replaced by
the cell's control or broken by a planted fault.

    python3 bench/calibrate.py --workload <cell> --seeds 1 2 3 \\
        [--controls 1 2 3] [--seconds 2] [--out readings.jsonl] \\
        [--leaves <pattern>]

For a GEMM cell the control puts in `dit_gemm`'s place each call's C
computed from the same operands in int4 (e4m3 cells) or e4m3 (bf16 cells),
and the fault `half_rows` leaves the lower half of each C out. For the
train cell the control puts in the program's readings those of the
reference trained with every GEMM's operands and incoming gradients
quantized to the traffic's `control` (e4m3, one scale a tensor), and the
fault `half_batch` drops half of each batch in the program's step (the
mean taken over the rest); a state left unchanged reads 1 on every number
but the loss's and needs no run. `--leaves` compares the train cell's
first gradients on the leaves the pattern names instead of the cell's
and writes `grad_diff` leaf by leaf.

Each seed gives one JSON line: each run's compared numbers, and whether it
came out correct under the cell's limits. The benchmark's own runs never
run this.
"""
from __future__ import annotations

import argparse
import io
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT), str(ROOT / "src")]

from bench.harness import core, runner  # noqa: E402


def gemm_control(traffic) -> None:
    """Each call's C computed below the operands' precision."""
    from bench.reference import gemm as ref
    traffic._call = lambda a, w: ref.control_c(a, w.T)


def half_rows(traffic) -> None:
    """The lower half of each C's rows left out."""
    call = traffic._call

    def broken(a, w):
        out = call(a, w).clone()
        out[out.shape[0] // 2:] = 0
        return out
    traffic._call = broken


def train_control(traffic) -> None:
    """The reference trained in the traffic's `control` precision in the
    program's place: its readings judged instead of the program's."""
    release = traffic.release

    def control():
        release()
        traffic.readings = traffic.reference_readings(
            precision=traffic.t["control"])
    traffic.release = control


def half_batch(traffic) -> None:
    """Half of each batch left out of the program's step, the mean taken
    over the rest."""
    checked = traffic._checked_steps

    def broken(o):
        step = traffic.s.step_fn
        traffic.s.step_fn = lambda state, batch: step(
            state, {k: v[: v.shape[0] // 2] for k, v in batch.items()})
        return checked(o)
    traffic._checked_steps = broken


PATCHES = {"gemm": {"control": gemm_control, "half_rows": half_rows},
           "train": {"control": train_control, "half_batch": half_batch}}
# a train step that returns its state unchanged: every norm and gradient
# gap reads 1 (no gradient in the first moment, no change), with no run
UNCHANGED = {"grad_norm_gap": 1.0, "change_norm_gap": 1.0, "grad_diff": 1.0}


def readings(name: str, seed: int, seconds: float, device: str, cell: dict,
             config: dict, controls: bool, leaves: bool = False) -> dict:
    """One seed's readings: the program's, and with `controls` the
    control's and the faults'; with `leaves` each leaf's `grad_diff`."""
    kind = core.load_module("traffic", cell["generator"]).Traffic.kind
    runs = {"program": None}
    if controls:
        runs.update(PATCHES[kind])
    out = {"workload": name, "seed": seed, "correct": {}}
    for run_name, patch in runs.items():
        seen = []

        def hook(traffic, patch=patch):
            seen.append(traffic)
            if patch is not None:
                patch(traffic)
        got = runner.execute(name, seed, seconds, False, device=device,
                             cell=cell, config=config, patch=hook,
                             out=io.StringIO())
        out[run_name] = {c.name: c.value for c in got["checks"]}
        out["correct"][run_name] = got["correct"]
        if leaves:
            out.setdefault("grad_diff_by_leaf", {})[run_name] = \
                seen[0].leaf_gaps
        del seen, got
    if controls and kind == "train":
        out["state_unchanged"] = dict(UNCHANGED)
    return out


def main(argv=None, device: str = "cuda", cell=None, config=None) -> list:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--controls", type=int, nargs="*", default=[])
    ap.add_argument("--seconds", type=float, default=2.0)
    ap.add_argument("--out", default="")
    ap.add_argument("--leaves", default=None,
                    help="train cell: compare first gradients on the leaves "
                         "this pattern names, and write each leaf's")
    args = ap.parse_args(argv)
    cell = cell or core.load_json("workloads", args.workload)
    config = config or core.load_json("configs", cell["config"])
    if args.leaves is not None:
        cell = dict(cell, traffic=dict(cell["traffic"],
                                       grad_diff_leaves=args.leaves))
    lines = []
    for seed in dict.fromkeys(args.seeds + args.controls):
        line = json.dumps(readings(args.workload, seed, args.seconds, device,
                                   cell, config, seed in args.controls,
                                   args.leaves is not None))
        print(line, flush=True)
        lines.append(line)
        if args.out:
            with open(args.out, "a") as f:
                f.write(line + "\n")
    return lines


if __name__ == "__main__":
    main()
