"""Parity of the port's SoftHier functional model (`sim/softhier.py`) with
the JAX package's, on the schedules `tests/test_dataflows.py` builds.

Both sides are numpy: each builds its own `Program` from its own
`Schedule` (`core.schedule.build_program`) on the same mini accelerator
and runs it on the same seeded operands, so `run_gemm`'s C, the superstep
count and the op counts must agree bitwise. `verify_gemm` (C against the
fp32 numpy product, rtol = atol = 1e-4) must pass on both, and must raise
on both when the simulated C is corrupted by one element.
"""
import numpy as np
import pytest

from repro.core import schedule as jsched
from repro.hw import config as jhw
from repro.sim import softhier as jsim
from repro_torch.core import schedule as tsched
from repro_torch.hw import config as thw
from repro_torch.sim import softhier as tsim

# (name, grid, (m, n, k), tiling, dataflow, schedule options, seed) as
# tests/test_dataflows.py builds them
CASES = [
    ("baseline", 4, (64, 64, 128), (4, 4, 1, 32), "baseline", {}, 0),
    ("summa", 4, (64, 64, 128), (4, 4, 1, 32), "summa", {}, 0),
    ("systolic", 4, (64, 64, 128), (4, 4, 1, 32), "systolic", {}, 0),
    ("splitk", 4, (64, 64, 128), (2, 2, 4, 16), "splitk_summa", {}, 0),
    ("sys/summa", 4, (64, 64, 128), (4, 4, 1, 16), "systolic_over_summa",
     {"inner": (2, 2)}, 0),
    ("summa/sys", 4, (64, 64, 128), (4, 4, 1, 16), "summa_over_systolic",
     {"inner": (2, 2)}, 0),
    ("summa-single-buffer", 4, (64, 64, 128), (4, 4, 1, 32), "summa",
     {"double_buffer": False}, 7),
    ("splitk-single-buffer", 4, (64, 64, 128), (2, 2, 4, 16),
     "splitk_summa", {"double_buffer": False}, 7),
    ("summa-iter2-stages4", 4, (128, 128, 64), (4, 4, 1, 32, 2, 2), "summa",
     {"store_stages": 4}, 3),
    ("remapped-flat", 4, (16, 64, 256), (1, 4, 4, 16), "splitk_summa", {},
     11),
    ("splitk-owner-first", 4, (32, 32, 128), (2, 2, 4, 16), "splitk_summa",
     {"reduce_owner": "first"}, 2),
    ("splitk-owner-round-robin", 4, (32, 32, 128), (2, 2, 4, 16),
     "splitk_summa", {"reduce_owner": "round_robin"}, 2),
    ("8x8-summa", 8, (128, 128, 128), (8, 8, 1, 32), "summa", {}, 5),
    ("8x8-hierarchical-4x4", 8, (128, 128, 256), (8, 8, 1, 16),
     "systolic_over_summa", {"inner": (4, 4)}, 6),
]


def _hw(pkg, grid: int):
    """tests/test_dataflows.py's mini accelerators: 4x4 with 8 HBM
    channels, 8x8 with 16, 4 MB of L1 a tile."""
    return pkg.AcceleratorConfig(
        name=f"mini{grid}", grid=(grid, grid),
        tile=pkg.TileConfig(l1_bytes=4 * 1024 * 1024), noc=pkg.NoCConfig(),
        hbm=pkg.HBMConfig(n_channels=2 * grid))


def _program(sched_mod, hw_mod, grid, mnk, tiling, dataflow, opts):
    gm, gn, gk, tk, *iters = tiling
    it = dict(zip(("iter_m", "iter_n"), iters))
    sched = sched_mod.Schedule(sched_mod.GEMMShape(*mnk),
                               sched_mod.Tiling(gm, gn, gk, tk=tk, **it),
                               dataflow, **opts)
    return sched_mod.build_program(sched, _hw(hw_mod, grid))


def _operands(mnk, seed):
    m, n, k = mnk
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((m, k)).astype(np.float32),
            rng.standard_normal((k, n)).astype(np.float32))


@pytest.mark.parametrize("name,grid,mnk,tiling,dataflow,opts,seed", CASES,
                         ids=[c[0] for c in CASES])
def test_run_gemm_bitwise_equal_to_reference(name, grid, mnk, tiling,
                                             dataflow, opts, seed,
                                             monkeypatch):
    a, b = _operands(mnk, seed)
    jprog = _program(jsched, jhw, grid, mnk, tiling, dataflow, opts)
    tprog = _program(tsched, thw, grid, mnk, tiling, dataflow, opts)
    jres = jsim.FunctionalSim(jprog, a, b).run()
    tres = tsim.FunctionalSim(tprog, a, b).run()
    assert tres.c.dtype == jres.c.dtype == np.float32
    np.testing.assert_array_equal(tres.c, jres.c)
    np.testing.assert_array_equal(tsim.run_gemm(tprog, a, b), jres.c)
    assert tres.supersteps == jres.supersteps == len(tprog.supersteps)
    assert tres.op_counts == jres.op_counts

    jsim.verify_gemm(jprog, a, b)
    tsim.verify_gemm(tprog, a, b)

    # one corrupted element of C: both checks must catch it
    for mod, prog in ((jsim, jprog), (tsim, tprog)):
        real = mod.run_gemm

        def corrupted(p, x, y, real=real):
            c = real(p, x, y).copy()
            c[0, -1] += 1e-2 * (1 + abs(c[0, -1]))
            return c
        monkeypatch.setattr(mod, "run_gemm", corrupted)
        with pytest.raises(AssertionError):
            mod.verify_gemm(prog, a, b)
        monkeypatch.setattr(mod, "run_gemm", real)


def test_sim_package_exports_the_functional_model():
    from repro_torch import sim
    assert sim.FunctionalSim is tsim.FunctionalSim
    assert sim.run_gemm is tsim.run_gemm
    assert sim.verify_gemm is tsim.verify_gemm
    assert sim.SimResult is tsim.SimResult
    assert {"FunctionalSim", "SimResult", "run_gemm", "verify_gemm"} <= set(
        sim.__all__)


def test_wrong_operand_shapes_raise_on_both():
    jprog = _program(jsched, jhw, 4, (64, 64, 128), (4, 4, 1, 32), "summa",
                     {})
    tprog = _program(tsched, thw, 4, (64, 64, 128), (4, 4, 1, 32), "summa",
                     {})
    a, b = _operands((64, 64, 64), 0)
    for mod, prog in ((jsim, jprog), (tsim, tprog)):
        with pytest.raises(ValueError, match="do not match"):
            mod.FunctionalSim(prog, a, b)
