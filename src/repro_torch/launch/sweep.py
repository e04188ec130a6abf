"""Dry-run sweep launcher: every (arch x shape) cell on the single-pod mesh
(with roofline accounting) AND the 2-pod mesh (trace proof only). Each cell
runs in a fresh subprocess (crash isolation; each initialises its own fake
world); completed cells are skipped on re-run (JSON cache). Before launching cells, the deployment-
plan cache is warmed across the union of every arch's GEMM workload (shapes
deduped across archs — the whole point of a shared plan store); the
persisted plans under --plan-cache are a sweep artifact alongside the
dry-run JSONs, reusable by any later Planner on the same hw fingerprint.

  PYTHONPATH=src python -m repro_torch.launch.sweep --out results/dryrun
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

from repro_torch.configs import cells, get_config, list_archs


def warm_plans(archs, cache_dir: str, grid, max_candidates: int) -> None:
    """Batch-tune the bucketed union of all archs' GEMM shapes."""
    from repro_torch.deploy import arch_workload
    from repro_torch.deploy.warmup import build_planner, warm_buckets

    workload = []
    for arch in archs:
        cfg = get_config(arch)
        for shape_name in cells(arch):
            workload += arch_workload(cfg, shape_name)
    warm_buckets(build_planner(cache_dir, grid, max_candidates), workload)


def cell_done(out: str, arch: str, shape: str, mp: bool) -> bool:
    path = os.path.join(out, f"{arch}__{shape}__{'mp' if mp else 'sp'}.json")
    if not os.path.exists(path):
        return False
    try:
        with open(path) as f:
            return json.load(f).get("status") == "ok"
    except Exception:
        return False


def run_one(out: str, arch: str, shape: str, mp: bool, timeout: int,
            plan_cache: str = "", plan_grid=(4, 4)) -> str:
    if cell_done(out, arch, shape, mp):
        return "cached"
    cmd = [sys.executable, "-m", "repro_torch.launch.dryrun",
           "--arch", arch, "--shape", shape, "--out", out]
    if plan_cache:
        # cells record their traced GEMM workload against the warmed cache
        # and report model_workload coverage in their JSON
        cmd += ["--plan-cache", plan_cache,
                "--plan-grid", str(plan_grid[0]), str(plan_grid[1])]
    if mp:
        cmd += ["--multi-pod", "--skip-accounting"]
    t0 = time.time()
    try:
        proc = subprocess.run(cmd, capture_output=True, text=True,
                              timeout=timeout)
        status = "ok" if proc.returncode == 0 else "error"
        if status == "error":
            tail = (proc.stderr or proc.stdout or "")[-1500:]
            path = os.path.join(
                out, f"{arch}__{shape}__{'mp' if mp else 'sp'}.json")
            if not os.path.exists(path):
                with open(path, "w") as f:
                    json.dump({"arch": arch, "shape": shape, "multi_pod": mp,
                               "status": "error", "error": "subprocess",
                               "traceback": tail}, f, indent=1)
    except subprocess.TimeoutExpired:
        status = "timeout"
        path = os.path.join(out, f"{arch}__{shape}__{'mp' if mp else 'sp'}.json")
        with open(path, "w") as f:
            json.dump({"arch": arch, "shape": shape, "multi_pod": mp,
                       "status": "error", "error": f"timeout {timeout}s"}, f)
    return f"{status} ({time.time()-t0:.0f}s)"


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--out", default="results/dryrun")
    ap.add_argument("--timeout", type=int, default=3000)
    ap.add_argument("--only-arch", default=None)
    ap.add_argument("--skip-multipod", action="store_true")
    from repro_torch.deploy.warmup import add_plan_args
    add_plan_args(ap)
    args = ap.parse_args()
    os.makedirs(args.out, exist_ok=True)

    archs = [args.only_arch] if args.only_arch else list_archs()
    plan_cache = ""
    if not args.skip_plan_warmup:
        warm_plans(archs, args.plan_cache, args.plan_grid,
                   args.plan_candidates)
        # cells (subprocesses) get the warmed cache via --plan-cache: each
        # installs a record-only gemm context and reports workload coverage
        plan_cache = args.plan_cache
    todo = []
    for arch in archs:
        for shape in cells(arch):
            todo.append((arch, shape, False))
    if not args.skip_multipod:
        for arch in archs:
            for shape in cells(arch):
                todo.append((arch, shape, True))

    for i, (arch, shape, mp) in enumerate(todo):
        tag = f"[{i+1}/{len(todo)}] {arch} {shape} {'2-pod' if mp else '1-pod'}"
        print(tag, "...", flush=True)
        print(tag, "->", run_one(args.out, arch, shape, mp, args.timeout,
                                 plan_cache=plan_cache,
                                 plan_grid=args.plan_grid),
              flush=True)


if __name__ == "__main__":
    main()
