"""Loss trajectories of a few train steps on one fixed batch, per learning
rate, on the card (needs one CUDA device).

    python3 tools/train_lr_probe.py --lrs 1e-3 3e-4 1e-4 [--routed]

Each learning rate starts from the same seeded weights (full-width
gemma-2b) and takes three AdamW steps at batch 2 x seq 1024 on
`SyntheticLM`'s batch 0 through `repro_torch.launch.train`'s own setup,
with the launcher's schedule (warm-up over max(5, steps // 20) steps),
through `chip_smoke.py`'s own `train_steps`. Unrouted (the default) every
matmul is `x @ w` (cuBLAS) with PyTorch's own backward; `--routed` warms
the plan cache and sends every forward GEMM through `mmad`. Prints, per
learning rate, the loss before each step and after the last one, and the
card's name and power limit.
"""
from __future__ import annotations

import argparse
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
BATCH, SEQ, STEPS = 2, 1024, 3


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--lrs", type=float, nargs="+", required=True)
    ap.add_argument("--routed", action="store_true")
    args = ap.parse_args()

    import torch
    if not torch.cuda.is_available():
        print("train_lr_probe: no CUDA device", file=sys.stderr)
        return 2
    sys.path[:0] = [str(ROOT / "src"), str(ROOT)]
    torch.backends.cuda.matmul.allow_tf32 = False
    import chip_smoke
    from repro_torch.launch import train
    from repro_torch.models import shard_ctx
    from repro_torch.obs import set_tracer
    from repro_torch.train import steps

    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip(), flush=True)
    for lr in args.lrs:
        argv = ["--arch", "gemma-2b", "--device", "cuda", "--batch",
                str(BATCH), "--seq", str(SEQ), "--steps", str(STEPS),
                "--lr", str(lr), "--plan-cache",
                str(ROOT / "build" / "lr_probe_plans")]
        argv += [] if args.routed else ["--skip-plan-warmup"]
        s = train.setup(train.parse_args(argv))
        batch = s.batch_arrays(s.data.batch(0))
        state, losses, _, _ = chip_smoke.train_steps(
            torch, s, batch, torch.device("cuda"), STEPS)
        with torch.no_grad():
            losses.append(float(steps.loss_fn(state[0], batch, s.cfg)))
        shard_ctx.set_gemm_context(None)
        set_tracer(None)
        print(f"{s.cfg.name} lr {lr:g} ({'routed' if args.routed else 'unrouted'}"
              f", batch {BATCH} x seq {SEQ}): loss before each of {STEPS} "
              f"steps, then after: "
              f"{[round(x, 6) for x in losses]}", flush=True)
        del state, batch, s
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
