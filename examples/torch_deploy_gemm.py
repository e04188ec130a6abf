"""Deploy-a-GEMM walkthrough on the PyTorch port: all of DiT's moving parts
on one page.

1. express a workload + hardware instance,
2. enumerate schedules, inspect how the insights shape the choice,
3. lower the winner to a BSP program and look at its supersteps,
4. verify numerically (SoftHier functional model) and cross-check the same
   dataflow as `torch.distributed` collectives on 4 gloo CPU processes
   (`core.gemm.summa_gemm` on a 2x2 `DistMesh`).

  PYTHONPATH=src python examples/torch_deploy_gemm.py

The counterpart of examples/deploy_gemm.py, whose cross-check runs
`shard_map` SUMMA on 4 fake XLA devices in a subprocess. Steps 1-4 run on
the host; the cross-check's ranks are CPU processes (spawned, rendezvous
through a file in a temporary directory, so no port is taken), each
asserting its global C against numpy's product. `main` prints the
reference's lines and returns the values it printed.
"""
import tempfile
import time
from pathlib import Path

import numpy as np

from repro_torch.core.autotuner import enumerate_candidates, tune
from repro_torch.core.schedule import GEMMShape, build_program
from repro_torch.hw.config import (AcceleratorConfig, HBMConfig, NoCConfig,
                                   TileConfig)
from repro_torch.sim.perf import estimate
from repro_torch.sim.softhier import run_gemm

RANKS = 4
MESH = (2, 2)
RANKS_TIMEOUT_S = 240


def summa_rank(rank: int, store: str) -> None:
    """One gloo rank of the cross-check: the reference's operands (rng 0,
    (32, 2048) @ (2048, 512), fp32) whole on every rank, SUMMA over the
    2x2 mesh's `data` x `model` axes, the global C held to numpy's product
    at the reference's tolerance."""
    import torch
    import torch.distributed as dist

    from repro_torch.core.gemm import summa_gemm
    from repro_torch.launch.mesh import make_dist_mesh

    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{store}",
                            rank=rank, world_size=RANKS)
    try:
        mesh = make_dist_mesh(MESH, "cpu")
        rng = np.random.default_rng(0)
        a = rng.standard_normal((32, 2048)).astype(np.float32)
        b = rng.standard_normal((2048, 512)).astype(np.float32)
        out = summa_gemm(torch.from_numpy(a), torch.from_numpy(b), mesh)
        np.testing.assert_allclose(out.numpy(), a @ b, rtol=1e-4, atol=1e-4)
    finally:
        dist.destroy_process_group()


def cross_check() -> list:
    """Spawn the RANKS processes of `summa_rank`; returns their exit codes
    (all 0 when every rank's C matched), after killing any rank still
    running at RANKS_TIMEOUT_S."""
    import torch.multiprocessing as mp

    ctx = mp.get_context("spawn")
    with tempfile.TemporaryDirectory() as tmp:
        store = str(Path(tmp) / "store")
        procs = [ctx.Process(target=summa_rank, args=(r, store))
                 for r in range(RANKS)]
        for p in procs:
            p.start()
        deadline = time.monotonic() + RANKS_TIMEOUT_S
        try:
            for p in procs:
                p.join(max(0.0, deadline - time.monotonic()))
        finally:
            for p in procs:
                if p.is_alive():
                    p.kill()
                    p.join()
    return [p.exitcode for p in procs]


def main(argv=None) -> dict:
    del argv                # no flags
    hw = AcceleratorConfig(name="demo-8x8", grid=(8, 8),
                           tile=TileConfig(l1_bytes=2 * 1024 * 1024),
                           noc=NoCConfig(), hbm=HBMConfig(n_channels=16))

    # a flat (decode-style) GEMM: M tiny, K large — Insight 4 territory
    shape = GEMMShape(32, 512, 2048)
    print(f"workload: {shape.m}x{shape.n}x{shape.k} flat GEMM on {hw.name}\n")

    print("top candidates (insight-ordered):")
    candidates = []
    for i, cand in enumerate(enumerate_candidates(shape, hw, elem_bytes=4,
                                                  max_candidates=6)):
        rep = estimate(build_program(cand, hw), hw)
        candidates.append((cand.describe(), rep.total_time))
        print(f"  {i}: {cand.describe():55s} -> {rep.total_time*1e6:8.1f} us")

    best = tune(shape, hw, elem_bytes=4, max_candidates=24)
    winner = best.schedule.describe()
    print(f"\nwinner: {winner}")
    prog = build_program(best.schedule, hw)
    ops = prog.op_counts()
    print(f"BSP program: {len(prog.supersteps)} supersteps, ops = {ops}")
    print("first supersteps:")
    for step in prog.supersteps[:3]:
        print(f"  [{step.label}] compute={len(step.compute)} "
              f"comm={len(step.comm)}")

    rng = np.random.default_rng(0)
    a = rng.standard_normal((shape.m, shape.k)).astype(np.float32)
    b = rng.standard_normal((shape.k, shape.n)).astype(np.float32)
    c = run_gemm(prog, a, b)
    err = float(np.abs(c - a @ b).max())
    print(f"\nfunctional verification: max |err| = {err:.2e}")

    print(f"\ncross-check: the same SUMMA dataflow as torch.distributed "
          f"collectives ({RANKS} gloo CPU processes)")
    codes = cross_check()
    if codes != [0] * RANKS:
        raise RuntimeError(f"SUMMA ranks exited with {codes}")
    print("  torch.distributed SUMMA == numpy: OK")
    return {"candidates": candidates, "winner": winner,
            "supersteps": len(prog.supersteps), "op_counts": ops,
            "max_abs_err": err, "rank_exit_codes": codes}


if __name__ == "__main__":
    main()
