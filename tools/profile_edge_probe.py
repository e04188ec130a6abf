"""Does a device-only `torch.profiler` window see every kernel the card ran?
On the card (needs one CUDA device).

    python3 tools/profile_edge_probe.py [--reps 8]

Full-width gemma-2b (random weights from the seed) decodes through the
routed path at `chip_smoke.py`'s batch, prompt and generation length. Per
repetition it prefills a fresh cache, then profiles the 32 decode steps
twice over, alternating: once in a bare device-only window (synchronized
at both ends, as `chip_smoke.py` profiled before) and once in
`chip_smoke.device_profile` (host pause and spin kernels at each edge).
Prints, per window, the device kernels of the decode steps the profile
holds, the `mmad` kernels among them against the wrapper's launch count
for the same steps, and for `device_profile` how many of its edge kernels
the profile kept; then the card's name and power limit. The work is the
same in every window, so a count that varies is the profiler losing events.
"""
from __future__ import annotations

import argparse
import contextlib
import importlib
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--reps", type=int, default=8)
    args = ap.parse_args()

    import torch
    if not torch.cuda.is_available():
        print("profile_edge_probe: no CUDA device", file=sys.stderr)
        return 2
    sys.path[:0] = [str(ROOT / "src"), str(ROOT)]
    import chip_smoke as cs
    from repro_torch.configs import get_config
    from repro_torch.kernels import build
    from repro_torch.launch import serve
    from repro_torch.models.model import decode_init, init_params
    from repro_torch.train.steps import make_serve_step

    mmad = importlib.import_module("repro_torch.kernels.mmad")
    build.build("mmad")
    cfg, dev = get_config("gemma-2b"), torch.device("cuda")
    params = init_params(torch.Generator(device=dev).manual_seed(cs.SEED),
                         cfg, dev)
    planner = serve.warm_plan_cache(
        cfg, cs.BATCH, cs.PROMPT, cs.PROMPT + cs.GEN,
        str(ROOT / "build" / "profile_edge_plans"), (4, 4), 12)
    prompts = torch.randint(
        0, cfg.vocab, (cs.BATCH, cs.PROMPT),
        generator=torch.Generator().manual_seed(cs.SEED)).to(dev)
    serve.install_gemm_context(planner, dev)
    step = make_serve_step(cfg)

    @contextlib.contextmanager
    def bare(torch, dev):
        acts = [torch.profiler.ProfilerActivity.CUDA]
        with torch.profiler.profile(activities=acts) as prof:
            torch.cuda.synchronize(dev)
            yield prof
            torch.cuda.synchronize(dev)

    windows = (("bare", bare), ("device_profile", cs.device_profile))
    with torch.inference_mode():
        for rep in range(args.reps):
            for name, window in windows:
                caches = decode_init(params, cfg, cs.BATCH,
                                     cs.PROMPT + cs.GEN)
                for i in range(cs.PROMPT):
                    logits, caches = step(params, caches,
                                          prompts[:, i:i + 1], i)
                tok = torch.argmax(logits, -1)[:, None]
                mmad.reset_launch_count()
                with window(torch, dev) as prof:
                    for i in range(cs.GEN):
                        logits, caches = step(params, caches, tok,
                                              cs.PROMPT + i)
                        tok = torch.argmax(logits, -1)[:, None]
                launched = mmad.launch_count()
                kernels = cs.device_kernels(torch, prof)
                seen = sum(c for _, c, k in kernels if "mmad" in k)
                edges = ("" if window is bare else
                         "; edge kernels kept %d + %d of 2 x %d" % (
                             *cs.edge_kernels_kept(torch, prof),
                             cs.PROFILE_EDGE_KERNELS))
                print(f"rep {rep} {name}: {sum(c for _, c, _ in kernels)} "
                      f"device kernels of the decode steps in the profile, "
                      f"{seen} of them mmad for {launched} mmad launches"
                      f"{edges}", flush=True)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip(), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
