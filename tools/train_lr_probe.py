"""Loss trajectories of a few train steps on one fixed batch, per learning
rate, on the card (needs one CUDA device).

    python3 tools/train_lr_probe.py --lrs 1e-3 3e-4 1e-4 [--routed]
        [--arch gemma-2b] [--layers N]

Each learning rate starts from the same seeded weights (full-width
`--arch`, gemma-2b by default, `--layers` deep if given) and takes three
AdamW steps at batch 2 x seq 1024 on `SyntheticLM`'s batch 0 (with a
frontend model's random frames or patches, as `chip_smoke.frontend_batch`
builds them) through `repro_torch.launch.train`'s own setup,
with the launcher's schedule (warm-up over max(5, steps // 20) steps),
through `chip_smoke.py`'s own `train_steps`. Unrouted (the default) every
matmul is `x @ w` (cuBLAS) with PyTorch's own backward; `--routed` warms
the plan cache and sends every forward GEMM through `mmad`. Prints, per
learning rate, the loss before each step and after the last one, the
peak device memory of the run (`torch.cuda.max_memory_allocated`), and
the card's name and power limit. A run that exhausts the card's memory
prints the peak reached before the failure and the probe exits 1, so a
depth cut can be read from one call at two depths.
"""
from __future__ import annotations

import argparse
import dataclasses
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
BATCH, SEQ, STEPS = 2, 1024, 3


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--lrs", type=float, nargs="+", required=True)
    ap.add_argument("--routed", action="store_true")
    ap.add_argument("--arch", default="gemma-2b")
    ap.add_argument("--layers", type=int, default=None,
                    help="depth cut (default: the full config)")
    args = ap.parse_args()

    import torch
    if not torch.cuda.is_available():
        print("train_lr_probe: no CUDA device", file=sys.stderr)
        return 2
    sys.path[:0] = [str(ROOT / "src"), str(ROOT)]
    torch.backends.cuda.matmul.allow_tf32 = False
    import chip_smoke
    from repro_torch.configs import get_config
    from repro_torch.launch import train
    from repro_torch.models import shard_ctx
    from repro_torch.obs import set_tracer
    from repro_torch.train import steps

    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip(), flush=True)
    status = 0
    for lr in args.lrs:
        torch.cuda.reset_peak_memory_stats()
        argv = ["--arch", args.arch, "--device", "cuda", "--batch",
                str(BATCH), "--seq", str(SEQ), "--steps", str(STEPS),
                "--lr", str(lr), "--plan-cache",
                str(ROOT / "build" / "lr_probe_plans")]
        argv += [] if args.routed else ["--skip-plan-warmup"]
        cfg = (dataclasses.replace(get_config(args.arch),
                                   n_layers=args.layers)
               if args.layers else None)
        s = train.setup(train.parse_args(argv), cfg=cfg)
        batch = (chip_smoke.frontend_batch if s.cfg.frontend != "none"
                 else chip_smoke.launcher_batch)(torch, s)
        run = (f"{s.cfg.name} at {s.cfg.n_layers} layers, lr {lr:g} "
               f"({'routed' if args.routed else 'unrouted'}, batch {BATCH} "
               f"x seq {SEQ})")
        state = None
        try:
            state, losses, _, _ = chip_smoke.train_steps(
                torch, s, batch, torch.device("cuda"), STEPS)
            with torch.no_grad():
                losses.append(float(steps.loss_fn(state[0], batch, s.cfg)))
            print(f"{run}: loss before each of {STEPS} steps, then after: "
                  f"{[round(x, 6) for x in losses]}; peak "
                  f"{torch.cuda.max_memory_allocated() / 1e9:.2f} GB",
                  flush=True)
        except torch.cuda.OutOfMemoryError as e:
            status = 1
            print(f"{run}: out of device memory after a peak of "
                  f"{torch.cuda.max_memory_allocated() / 1e9:.2f} GB: "
                  f"{str(e).splitlines()[0]}", flush=True)
        finally:
            shard_ctx.set_gemm_context(None)
            set_tracer(None)
        del state, batch, s
        chip_smoke.release(torch)
    return status


if __name__ == "__main__":
    sys.exit(main())
