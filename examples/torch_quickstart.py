"""Quickstart on the PyTorch port: deploy a GEMM with DiT, inspect the
schedule the autotuner picks, verify it numerically on the SoftHier
functional model, and price it on the GH200-class instance.

  PYTHONPATH=src python examples/torch_quickstart.py

The counterpart of examples/quickstart.py. It touches no device: the
autotuner, the cost model and the functional model are numpy code on the
host, in the port as in the reference, so there is no `--device` flag.
`main` prints the reference's lines and returns the values it printed.
"""
import numpy as np

from repro_torch.core.autotuner import tune
from repro_torch.core.schedule import GEMMShape, Schedule, Tiling, build_program
from repro_torch.hw.config import (AcceleratorConfig, HBMConfig, NoCConfig,
                                   TileConfig, softhier_gh200)
from repro_torch.sim.perf import estimate
from repro_torch.sim.softhier import verify_gemm


def main(argv=None) -> dict:
    del argv                # no flags: nothing here runs on a device
    # -- 1. autotune a deployment for an irregular DeepSeek-V3 projection --
    hw = softhier_gh200()
    shape = GEMMShape(4096, 2112, 7168)
    result = tune(shape, hw, elem_bytes=1, max_candidates=24)
    best = result.schedule.describe()
    predicted = result.report.summary(hw)
    print(f"GEMM {shape.m}x{shape.n}x{shape.k} on {hw.name}")
    print(f"  best schedule : {best}")
    print(f"  predicted     : {predicted}")
    print(f"  candidates    : {result.candidates_tried}")

    # -- 2. the same schedule machinery at toy scale, verified functionally -
    mini = AcceleratorConfig(name="mini", grid=(4, 4),
                             tile=TileConfig(l1_bytes=4 * 1024 * 1024),
                             noc=NoCConfig(), hbm=HBMConfig(n_channels=8))
    sched = Schedule(GEMMShape(64, 64, 128), Tiling(4, 4, 1, tk=32), "summa")
    prog = build_program(sched, mini)
    rng = np.random.default_rng(0)
    a = rng.standard_normal((64, 128)).astype(np.float32)
    b = rng.standard_normal((128, 64)).astype(np.float32)
    verify_gemm(prog, a, b)    # raises if the BSP program's C != A @ B
    supersteps = len(prog.supersteps)
    multicasts = prog.op_counts()["multicast"]
    cost_model = estimate(prog, mini).summary(mini)
    print(f"\nfunctional check on mini 4x4 instance: OK "
          f"({supersteps} BSP supersteps, {multicasts} hardware multicasts)")
    print(f"  cost model    : {cost_model}")
    return {"best_schedule": best, "predicted": predicted,
            "candidates_tried": result.candidates_tried,
            "supersteps": supersteps, "multicasts": multicasts,
            "cost_model": cost_model}


if __name__ == "__main__":
    main()
