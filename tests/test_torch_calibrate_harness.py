"""The calibration harness (`sim/calibrate.py`'s `time_best_of`,
`measure_modes`, `calibrate_mesh`) and the dry run's `--calibrate` guards.

`measure_modes` runs in this process over a fake 16-rank world (the
"fake" `torch.distributed` backend, CPU tensors: the mode bodies run and
are timed, the collectives move no data). What it pairs with each timing
— the GEMM, the dataflow, the mode its lowering ran and the analytical
report — must equal what the reference builds for the same row:
`build_mode_schedule` -> `lower_schedule` on a jax `AbstractMesh` ->
`estimate`. One test spawns the 16 gloo CPU processes `--calibrate-device
cpu` asks for, on one tiny GEMM.
"""
import pytest
import torch
import torch.distributed as dist
from jax.sharding import AbstractMesh

from repro.core.lower import lower_schedule as ref_lower
from repro.core.schedule import build_program as ref_build_program
from repro.hw.config import tpu_pod_as_accelerator as ref_pod
from repro.sim import calibrate as ref_cal
from repro.sim.perf import estimate as ref_estimate
from repro_torch.hw.config import tpu_pod_as_accelerator
from repro_torch.launch.dryrun import calibrate_plan_cache
from repro_torch.launch.mesh import HostMesh, make_dist_mesh
from repro_torch.sim import calibrate as cal

GEMMS = ((64, 64, 128),)


def test_no_world_and_no_mesh_raises():
    assert not dist.is_initialized()
    with pytest.raises(ValueError, match="4x4 ranks"):
        cal.measure_modes(tpu_pod_as_accelerator((4, 4)), gemms=GEMMS,
                          reps=1)


@pytest.fixture(scope="module")
def mesh():
    from torch.testing._internal.distributed.fake_pg import FakeStore
    assert not dist.is_initialized()
    dist.init_process_group("fake", rank=0, world_size=16, store=FakeStore())
    try:
        yield make_dist_mesh((4, 4), "cpu")
    finally:
        dist.destroy_process_group()


def _reference_rows(shape):
    """(shape, dataflow, mode, report dict) per MODE_CASES row, as the
    reference's measure_modes pairs them with its timings."""
    hw = ref_pod((4, 4))
    amesh = AbstractMesh((4, 4), ("data", "model"))
    rows = []
    for label, df, kw in ref_cal.MODE_CASES:
        sched = ref_cal.build_mode_schedule(df, kw, 4, 4, shape,
                                            elem_bytes=hw.tile.elem_bytes)
        ep = ref_lower(sched, amesh, "data", "model", shape=shape)
        assert ep.mode == label and not ep.degraded
        rows.append((tuple(shape), df, label,
                     ref_estimate(ref_build_program(sched, hw),
                                  hw).to_dict()))
    return rows


def test_measure_modes_pairs_the_reference_rows(mesh):
    samples = cal.measure_modes(tpu_pod_as_accelerator((4, 4)), mesh,
                                gemms=GEMMS, reps=1)
    assert len(samples) == len(cal.MODE_CASES) == 5
    got = [(tuple(s.shape), s.dataflow, s.mode, s.report.to_dict())
           for s in samples]
    assert got == _reference_rows(GEMMS[0])
    assert all(s.measured_s > 0 for s in samples)
    assert cal.MODE_CASES == ref_cal.MODE_CASES
    assert cal.DEFAULT_GEMM_GRID == ref_cal.DEFAULT_GEMM_GRID


def test_measure_modes_builds_its_mesh_over_the_world(mesh):
    samples = cal.measure_modes(tpu_pod_as_accelerator((4, 4)), None,
                                gemms=GEMMS, reps=1)
    assert [s.mode for s in samples] == [m for m, _, _ in cal.MODE_CASES]


def test_measure_modes_guards(mesh):
    with pytest.raises(ValueError, match="does not match hw.grid"):
        cal.measure_modes(tpu_pod_as_accelerator((2, 8)), mesh,
                          gemms=GEMMS, reps=1)
    # the one-card mesh cannot host the table: split-K SUMMA degrades
    with pytest.raises(RuntimeError, match="expected clean splitk_summa"):
        cal.measure_modes(tpu_pod_as_accelerator((1, 1)),
                          HostMesh(torch.device("cpu")), gemms=GEMMS, reps=1)


def test_calibrate_mesh_fits_its_samples(mesh):
    hw = tpu_pod_as_accelerator((4, 4))
    profile, samples = cal.calibrate_mesh(hw, mesh, gemms=GEMMS, reps=1)
    assert len(samples) == 5
    assert profile.to_dict() == cal.fit_profile(samples, hw).to_dict()


def test_time_best_of_keeps_the_discipline(mesh):
    calls = []

    def fn(a, b):
        calls.append(1)
        return a @ b
    a = torch.ones(4, 4)
    t = cal.time_best_of(fn, a, a, 2, mesh)
    assert t >= 0 and len(calls) == 1 + 2 * 3     # warm + reps x 3


@pytest.mark.parametrize("grid", [(2, 2), (4, 8), (3, 3)])
def test_calibrate_refuses_small_or_oblong_grids(grid, tmp_path):
    with pytest.raises(ValueError, match="square --plan-grid of at least "
                                         "4x4"):
        calibrate_plan_cache(str(tmp_path), grid, device="cpu")


@pytest.mark.parametrize("cards", [0, 1, 15])
def test_calibrate_on_cuda_needs_a_card_per_rank(cards, tmp_path,
                                                  monkeypatch):
    """Too few cards raises and names the count; nothing falls back to the
    CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: cards > 0)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: cards)
    with pytest.raises(RuntimeError, match=f"needs 16 visible CUDA cards "
                                           f".*; {cards} visible"):
        calibrate_plan_cache(str(tmp_path), (4, 4), device="cuda")


def test_calibrate_plan_cache_over_gloo_processes(tmp_path):
    """16 spawned gloo ranks measure one tiny GEMM; rank 0 persists the
    profile and its samples where the planner loads them."""
    out = calibrate_plan_cache(str(tmp_path), (4, 4), reps=1, device="cpu",
                               gemms=GEMMS)
    hw = tpu_pod_as_accelerator((4, 4))
    assert out["samples"] == 5 and out["device"] == "cpu"
    profile = cal.load_profile(str(tmp_path), hw)
    assert profile is not None and out["profile"] == profile.to_dict()
    assert [s.mode for s in cal.load_samples(str(tmp_path), hw)] == \
        [m for m, _, _ in cal.MODE_CASES]
