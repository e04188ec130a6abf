"""The second schedule level on the card: the H100 card view, its inner
kernels, and their lowering (CPU only, seeded, ~10 s).

- `h100_as_accelerator`'s constants against `H100_SXM` and the cited
  shared-memory budget; the tensor-core instance list against its
  legality rule, `kernels/mmad.py`'s mirror and `csrc/mmad.cu`'s table;
- on the card view, every inner-kernel candidate of gemma-2b's train and
  decode shapes and of the 18 DeepGEMM fp8 shapes is a compiled instance
  whose ring fits 227 KB, and the route's own 128 x 256 x 64 4-stage tile
  is a candidate wherever it runs today;
- on the reference's views (`tpu-v5e-pod`, `softhier-gh200`) the port's
  candidates, tuned plans and CPU-mesh lowerings equal the reference's;
- on a CUDA mesh (a `HostMesh` on a CUDA device: lowering reads only its
  device type), a kernel the card does not run is demoted under
  `inner_kernel_no_instance`, counted in `GemmStats.degrades`, and a
  card-view kernel is kept;
- `plan_launch` runs the instance it is given and raises for any other
  geometry.
"""
import dataclasses
import importlib
import re
import types
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

from repro.core import autotuner as jtuner  # noqa: E402
from repro.core import lower as jlower  # noqa: E402
from repro.core import schedule as jsched  # noqa: E402
from repro.hw import config as jhw  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.core import autotuner, lower, schedule  # noqa: E402
from repro_torch.core.schedule import GEMMShape, InnerKernel  # noqa: E402
from repro_torch.deploy import model_workload  # noqa: E402
from repro_torch.deploy.plan import hw_fingerprint  # noqa: E402
from repro_torch.deploy.warmup import plan_view  # noqa: E402
from repro_torch.hw import config as hw  # noqa: E402
from repro_torch.launch.mesh import HostMesh  # noqa: E402
from repro_torch.models.shard_ctx import GemmStats  # noqa: E402

mmad_mod = importlib.import_module("repro_torch.kernels.mmad")
CU = Path(mmad_mod.__file__).resolve().parent / "csrc" / "mmad.cu"
CARD = hw.h100_as_accelerator()
CUDA_MESH = HostMesh(device=torch.device("cuda"))
CPU_MESH = HostMesh(device=torch.device("cpu"))
ROUTE_OWN = hw.TensorCoreInstance("16bit", 128, 256, 64, 4)

# gemma-2b at chip_smoke.py's widths: train batch 2 x seq 1024, decode
# batch 4; the DeepGEMM fp8 shapes (the paper's 18: M x (N, K))
GEMMA = get_config("gemma-2b")
TRAIN = model_workload(GEMMA, 2, 1024, kind="train")
DECODE = model_workload(GEMMA, 4, 1, kind="decode")
DEEPGEMM_NK = [(2112, 7168), (24576, 1536), (32768, 512), (7168, 16384),
               (4096, 7168), (7168, 2048)]
DEEPGEMM = [GEMMShape(m, n, k) for m in (4096, 64, 128)
            for n, k in DEEPGEMM_NK]


# ---------------------------------------------------------------------------
# the card view and its instances
# ---------------------------------------------------------------------------

def test_card_view_takes_the_h100_constants():
    c = hw.H100_SXM
    assert isinstance(CARD, hw.CardViewConfig)
    assert CARD.name == "h100-sxm-1x1" and CARD.grid == (1, 1)
    assert (CARD.tile.peak_flops, CARD.tile.l1_bw) == (989.4e12, 3.35e12)
    assert (CARD.tile.peak_flops, CARD.tile.l1_bw) == (c.peak_flops_bf16,
                                                       c.hbm_bw)
    assert (CARD.tile.ce_rows, CARD.tile.ce_cols) == (64, 64)
    assert CARD.tile.l1_bytes == c.hbm_bytes
    assert (CARD.hbm.n_channels, CARD.hbm.channel_bw) == (1, c.hbm_bw)
    assert CARD.noc.link_bw == c.nvlink_bw / 2
    assert hw.H100_STREAM_MAX_M == mmad_mod.STREAM_MAX_M == 16
    assert hw.H100_NATIVE_DTYPES == ("bfloat16", "float8_e4m3")
    # the instance list enters the view's fingerprint, and only from the
    # constant: the view takes no list of its own
    assert CARD.tc_instances.split()[0] == "16bit:128x256x64s4"
    assert len(CARD.tc_instances.split()) == len(hw.H100_TC_INSTANCES)
    with pytest.raises(TypeError):
        hw.CardViewConfig(name="x", grid=(1, 1), tile=CARD.tile,
                          noc=CARD.noc, hbm=CARD.hbm, tc_instances="")
    assert schedule.INNER_SMEM_BUDGET == 232_448 == 227 * 1024
    four = hw.h100_as_accelerator((2, 2))
    assert four.hbm.n_channels == 4 and four.n_tiles == 4
    assert hw.get_accelerator("h100-sxm") == CARD


def test_reference_presets_are_unchanged():
    """The reference's views, byte for byte: every preset the reference
    has, field by field."""
    for name, ref_fn in jhw.PRESETS.items():
        assert dataclasses.asdict(hw.PRESETS[name]()) == \
            dataclasses.asdict(ref_fn())
    assert set(hw.PRESETS) == set(jhw.PRESETS) | {"h100-sxm"}


@pytest.mark.parametrize("inst", hw.H100_TC_INSTANCES,
                         ids=[f"{i.family}-{i.bm}x{i.bn}x{i.bk}"
                              for i in hw.H100_TC_INSTANCES])
def test_each_instance_takes_the_deepest_ring_that_fits(inst):
    """Legal (ring within 227 KB, accumulators within the consumers'
    registers), and as many stages as fit, at most six."""
    assert schedule.instance_legal(inst)
    assert inst.bk == (128 if inst.family == "e4m3" else 64)
    deeper = inst._replace(stages=inst.stages + 1)
    assert inst.stages == 6 or \
        schedule.ring_bytes(deeper) > schedule.INNER_SMEM_BUDGET


def test_instance_list_is_what_mmad_cu_compiles():
    """hw/config's list (which kernels/mmad.py launches by) and
    csrc/mmad.cu's TC_INSTANCES table, row for row; the route's own tile
    is the first."""
    rows = re.findall(r"\{TC_(16BIT|E4M3), (\d+), (\d+), (\d+), (\d+)\}",
                      CU.read_text())
    family = {"16BIT": "16bit", "E4M3": "e4m3"}
    cu = tuple(hw.TensorCoreInstance(family[f], *map(int, r))
               for f, *r in rows)
    assert cu == mmad_mod.TC_INSTANCES == hw.H100_TC_INSTANCES
    assert mmad_mod.WGMMA_INSTANCE == ROUTE_OWN
    assert schedule.ring_bytes(ROUTE_OWN) == 4 * 48 * 1024 + 1024 + 64


# ---------------------------------------------------------------------------
# card-view candidates at the main path's shapes
# ---------------------------------------------------------------------------

def _candidates(shape, elem_bytes, max_candidates=16):
    return [(s, schedule.inner_kernel_candidates(s, CARD))
            for s in autotuner.enumerate_candidates(
                shape, CARD, elem_bytes=elem_bytes,
                max_candidates=max_candidates)]


@pytest.mark.parametrize("kind,shapes,elem_bytes", [
    ("train", TRAIN, 2), ("decode", DECODE, 2), ("deepgemm", DEEPGEMM, 1)])
def test_card_candidates_are_compiled_instances(kind, shapes, elem_bytes):
    """Every candidate names a compiled instance of the schedule dtype's
    family whose ring fits 227 KB and whose tile fits the device block; no
    candidate where the stream kernels take the rows (decode, M = 4, and
    fp8 at M = 64 has no 64-row tile). The route's own 128 x 256 x 64
    4-stage tile is a candidate of every train shape it runs today."""
    for shape in shapes:
        pairs = _candidates(shape, elem_bytes)
        assert pairs
        for sched, cands in pairs:
            t = sched.tiling
            rows = shape.m // t.gm
            for ik in cands:
                inst = schedule.tensor_core_instance(ik)
                assert inst in hw.H100_TC_INSTANCES
                assert schedule.ring_bytes(inst) <= 232_448
                assert ik.dtype == ("float8_e4m3" if elem_bytes == 1
                                    else "bfloat16")
                assert ik.bm <= rows and ik.bn <= shape.n // t.gn
            if rows <= 16 or (elem_bytes == 1 and rows < 128):
                assert cands == ()
        if kind == "train":
            assert any(schedule.tensor_core_instance(ik) == ROUTE_OWN
                       for _, cands in pairs for ik in cands), shape


def test_card_plans_name_the_route_tile_at_gemma_train_shapes():
    """The reference's `_engine_time` has no wave term: on the card view
    every gemma-2b train shape's tuned plan names the largest tile, the
    route's own, with its ring depth."""
    for shape in TRAIN:
        res = autotuner.tune(shape, CARD, elem_bytes=2, max_candidates=8)
        assert schedule.tensor_core_instance(
            res.schedule.inner_kernel) == ROUTE_OWN, shape


@pytest.mark.parametrize("elem_bytes,want", [(1, "float8_e4m3"),
                                             (2, "bfloat16"),
                                             (4, "float32")])
def test_card_view_names_its_native_dtypes(elem_bytes, want):
    """A 1-byte schedule on the card is e4m3 (its tensor cores' 1-byte
    type here), not the reference's int8 default; the reference views
    resolve as the reference does."""
    assert schedule.default_elem_dtype(elem_bytes, CARD) == want
    for name, fn in jhw.PRESETS.items():
        assert schedule.default_elem_dtype(elem_bytes, hw.PRESETS[name]()) \
            == jsched.default_elem_dtype(elem_bytes, fn())


# ---------------------------------------------------------------------------
# the reference's views: bitwise the reference
# ---------------------------------------------------------------------------

REF_CASES = [
    ("tpu-v5e-pod", (4, 4), GEMMShape(2048, 2048, 2048), 2),
    ("tpu-v5e-pod", (4, 4), GEMMShape(2048, 256, 2048), 2),
    ("tpu-v5e-pod", (4, 4), GEMMShape(4, 2048, 16384), 2),
    ("tpu-v5e-pod", (2, 2), GEMMShape(1024, 4096, 2048), 2),
    ("softhier-gh200", None, GEMMShape(128, 2112, 7168), 1),
    ("softhier-gh200", None, GEMMShape(64, 2112, 7168), 1),
]


def _views(name, grid):
    if grid is None:
        return hw.PRESETS[name](), jhw.PRESETS[name]()
    return hw.PRESETS[name](grid), jhw.PRESETS[name](grid)


@pytest.mark.parametrize("case", REF_CASES,
                         ids=[f"{c[0]}-{c[2].m}x{c[2].n}x{c[2].k}"
                              for c in REF_CASES])
def test_reference_views_plan_and_lower_as_the_reference(case):
    """The candidates of every enumerated schedule, the tuned plan, and its
    lowering on a CPU mesh (1x1, and the view's grid) equal the
    reference's: the card view changed nothing on the reference's."""
    name, grid, shape, eb = case
    thw, jhw_ = _views(name, grid)
    jshape = jsched.GEMMShape(shape.m, shape.n, shape.k)
    tc = autotuner.enumerate_candidates(shape, thw, elem_bytes=eb,
                                        max_candidates=8)
    jc = jtuner.enumerate_candidates(jshape, jhw_, elem_bytes=eb,
                                     max_candidates=8)
    assert [s.describe() for s in tc] == [s.describe() for s in jc]
    for ts, js in zip(tc, jc):
        assert [k.to_dict() for k in schedule.inner_kernel_candidates(
            ts, thw)] == [k.to_dict() for k in jsched.inner_kernel_candidates(
                js, jhw_)]
    tres = autotuner.tune(shape, thw, elem_bytes=eb, max_candidates=8)
    jres = jtuner.tune(jshape, jhw_, elem_bytes=eb, max_candidates=8)
    assert tres.schedule.describe() == jres.schedule.describe()
    assert tres.report.total_time == jres.report.total_time
    rows, cols = grid or (1, 1)
    for dm, dn in {(1, 1), (rows, cols)}:
        mesh = types.SimpleNamespace(shape={"data": dm, "model": dn})
        tep = lower.lower_schedule(tres.schedule, mesh)
        jep = jlower.lower_schedule(jres.schedule, mesh)
        assert tep.to_dict() == jep.to_dict()
    assert lower.lower_schedule(tres.schedule, CPU_MESH).to_dict() == \
        jlower.lower_schedule(jres.schedule, CPU_MESH).to_dict()


# ---------------------------------------------------------------------------
# lowering on a CUDA mesh
# ---------------------------------------------------------------------------

def _sched(shape, ik, dataflow="summa"):
    return schedule.Schedule(shape=shape, tiling=schedule.Tiling(1, 1),
                             dataflow=dataflow, elem_bytes=2,
                             inner_kernel=ik)


SHAPE = GEMMShape(2048, 2048, 2048)
CARD_IK = InnerKernel(128, 256, 64, depth=4, dtype="bfloat16")


@pytest.mark.parametrize("ik,operand_dtype,m,kept", [
    (CARD_IK, None, 2048, True),
    (CARD_IK, "bfloat16", 2048, True),
    (CARD_IK, "float16", 2048, True),              # one 16-bit kernel
    (InnerKernel(64, 64, 64, depth=6, dtype="bfloat16"), "bfloat16", 17,
     True),
    (InnerKernel(128, 192, 128, depth=5, dtype="float8_e4m3"),
     "float8_e4m3", 4096, True),
    (InnerKernel(128, 128, 512, depth=2, dtype="bfloat16"), None, 2048,
     False),                                       # a tpu-v5e-pod kernel
    (InnerKernel(128, 256, 64, depth=2, dtype="bfloat16"), None, 2048,
     False),                                       # the tile, not its ring
    (InnerKernel(64, 16, 128, depth=2, dtype="float8_e4m3"), None, 4096,
     False),                                       # a softhier-gh200 kernel
    (CARD_IK, "", 2048, False),                    # fp32: the SIMT route
    (CARD_IK, "float8_e4m3", 2048, False),         # another family
    (CARD_IK, "bfloat16", 16, False),              # the stream kernels' rows
], ids=["card", "card-bf16", "card-fp16", "card-64", "card-fp8", "tpu",
        "depth", "gh200", "fp32", "family", "stream-rows"])
def test_cuda_mesh_runs_an_instance_or_demotes_it(ik, operand_dtype, m,
                                                  kept):
    """On a CUDA mesh an inner kernel is kept only where the card runs it
    (`card_runs`); any other is demoted under `inner_kernel_no_instance`
    (mode unchanged), which `GemmStats.degrades` counts. On a CPU mesh
    the same lowering is the reference's: nothing is demoted."""
    shape = GEMMShape(m, 2048, 2048)
    ep = lower.lower_schedule(_sched(shape, ik), CUDA_MESH,
                              operand_dtype=operand_dtype)
    assert ep.mode == "summa"
    assert lower.card_runs(ik, m, operand_dtype) == kept
    if kept:
        assert ep.inner_kernel == ik and not ep.fallbacks
    else:
        assert ep.inner_kernel is None
        assert ep.reasons() == (lower.INNER_KERNEL_NO_INSTANCE,)
        assert lower.INNER_KERNEL_NO_INSTANCE in lower.REASONS
    stats = GemmStats()
    stats.record_lowering(ep)
    assert stats.degrades == ({} if kept
                              else {lower.INNER_KERNEL_NO_INSTANCE: 1})
    cpu = lower.lower_schedule(_sched(shape, ik), CPU_MESH,
                               operand_dtype=operand_dtype)
    assert cpu.inner_kernel == ik and not cpu.fallbacks


@pytest.mark.parametrize("dtype,kept", [(torch.bfloat16, True),
                                        (torch.float32, False)])
def test_lower_for_reads_the_operands(dtype, kept):
    """`core.gemm.lower_for`, the dispatch's lowering: on a CUDA mesh the
    operands' tensor-core dtype (`ops.tensor_core_dtype`) decides, so a
    bf16 plan's kernel over fp32 operands (the MoE router) is demoted by
    name before any launch."""
    from repro_torch.core.gemm import lower_for
    from repro_torch.kernels.ops import tensor_core_dtype
    a = torch.zeros((2048, 512), dtype=dtype)
    b = torch.zeros((512, 64), dtype=dtype)
    ik = InnerKernel(128, 64, 64, depth=6, dtype="bfloat16")
    assert tensor_core_dtype(ik, a, b) == ("bfloat16" if kept else "")
    ep = lower_for(_sched(GEMMShape(2048, 64, 512), ik), CUDA_MESH, a, b)
    assert (ep.inner_kernel == ik) == kept
    assert lower_for(_sched(GEMMShape(2048, 64, 512), ik), CPU_MESH, a,
                     b).inner_kernel == ik


_DT = {"bfloat16": torch.bfloat16, "float16": torch.float16,
       "float32": torch.float32}


@pytest.mark.parametrize("have", [torch.float16, torch.bfloat16,
                                  torch.float32])
@pytest.mark.parametrize("kernel_dtype", ["bfloat16", "float16", "float32"])
def test_tensor_core_dtype_casts_nothing(have, kernel_dtype, monkeypatch):
    """`ops.tensor_core_dtype` says what `local_matmul` would launch in
    after `_cast_operand`, for B in either major and a B that is not dense
    (which the cast makes contiguous), without casting either operand."""
    from repro_torch.kernels import ops
    g = torch.Generator().manual_seed(28)
    ik = InnerKernel(128, 64, 64, depth=6, dtype=kernel_dtype)
    a = torch.randn((2048, 512), generator=g).to(have)
    bs = [torch.randn((512, 64), generator=g).to(have),
          torch.randn((64, 512), generator=g).to(have).T,
          torch.randn((512, 96), generator=g).to(have)[:, 8:72]]
    wants = []
    for b in bs:
        ca, cb = ops._cast_operand(a, ik), ops._cast_operand(b, ik)
        wants.append(ops._NAME_OF_DTYPE[ca.dtype]
                     if mmad_mod.takes_tensor_cores(ca, cb) else "")

    def refused(*args):
        raise AssertionError("tensor_core_dtype cast an operand")
    monkeypatch.setattr(ops, "_cast_operand", refused)
    monkeypatch.setattr(torch.Tensor, "to", refused)
    assert [ops.tensor_core_dtype(ik, a, b) for b in bs] == wants
    # a 16-bit kernel over 16-bit data casts it; fp32 on either side
    # keeps the product off the tensor cores
    assert wants[0] == ("" if torch.float32 in (have, _DT[kernel_dtype])
                        else kernel_dtype)


def test_plan_view_follows_the_mesh_device(tmp_path):
    """A CUDA mesh prices the card view at its card count, a CPU mesh the
    reference's TPU pod view at --plan-grid; their fingerprints differ, so
    one cache dir never serves a plan of one view to the other."""
    tpu = plan_view((4, 4), mesh=CPU_MESH)
    assert tpu == hw.tpu_pod_as_accelerator((4, 4))
    assert plan_view((4, 4)) == tpu
    assert plan_view((4, 4), mesh=CUDA_MESH) == CARD
    assert plan_view((4, 4), device="cuda") == CARD
    wide = types.SimpleNamespace(device=torch.device("cuda"),
                                 shape={"data": 2, "model": 2})
    assert plan_view((4, 4), mesh=wide) == hw.h100_as_accelerator((2, 2))
    assert hw_fingerprint(tpu) != hw_fingerprint(CARD)


# ---------------------------------------------------------------------------
# plan_launch at an instance
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("inst", hw.H100_TC_INSTANCES,
                         ids=[f"{i.family}-{i.bm}x{i.bn}x{i.bk}"
                              for i in hw.H100_TC_INSTANCES])
def test_plan_launch_runs_the_given_instance(inst):
    """Given (bm, bn, bk) and stages, `plan_launch` returns that instance
    (grid and ring as `wgmma_geometry` / `fp8_geometry` lay it out); the
    same tile at another ring depth raises, naming the geometry."""
    fp8 = inst.family == "e4m3"
    eb = 1 if fp8 else 2
    m, n, k = 4096, 2112, 7168
    block = (inst.bm, inst.bn, inst.bk)
    launch = mmad_mod.plan_launch(m, n, k, block, 132, None, eb, "n",
                                  False, inst.stages)
    assert launch.instance == inst
    assert launch[0] == (mmad_mod.WGMMA_FP8 if fp8 else mmad_mod.WGMMA)
    assert mmad_mod.plan_launch(m, n, k, block, 132, None, eb, "n",
                                False).instance == inst
    if fp8:
        geo = mmad_mod.fp8_geometry(m, n, k, "n", 132, inst)
        assert (geo.bn, geo.stages, geo.instance) == (inst.bn, inst.stages,
                                                      inst)
    else:
        geo = mmad_mod.wgmma_geometry(m, n, k, inst)
        assert geo.grid == (-(-m // inst.bm), -(-n // inst.bn))
    assert geo.smem_bytes == schedule.ring_bytes(inst)
    with pytest.raises(ValueError, match=f"{inst.bm} x {inst.bn} x "
                                         f"{inst.bk} with 3 stages"):
        mmad_mod.plan_launch(m, n, k, block, 132, None, eb, "n", False, 3)


def test_plan_launch_without_a_block_runs_the_routes_own():
    assert mmad_mod.plan_launch(2048, 2048, 2048, None, 132, None, 2,
                                "n").instance == ROUTE_OWN
    for m, bn in ((4096, 192), (128, 128)):
        assert mmad_mod.plan_launch(m, 2112, 7168, None, 132, None, 1,
                                    "n").instance == \
            mmad_mod.fp8_instance(bn)


def test_plan_vs_route_reads_the_shapes_whose_plan_named_another(
        monkeypatch, capsys):
    """`chip_smoke.plan_vs_route` keeps the timed shapes that were also
    timed at the route's own geometry, and prices the plan's choice over
    a step's launches."""
    monkeypatch.syspath_prepend(str(Path(__file__).resolve().parents[1]))
    chip_smoke = importlib.import_module("chip_smoke")
    row = {"path": "olmo-1b train", "shape": [2048, 64, 2048],
           "block": [128, 64, 64, 6], "route": [128, 256, 64, 4],
           "kernel_ms": 0.020, "route_ms": 0.012, "bound_ms": 0.004,
           "launches_per_step": 12}
    same = dict(row, block=[128, 256, 64, 4])
    del same["route"], same["route_ms"]
    got = chip_smoke.plan_vs_route([[same], [row]])
    assert [(r["plan"], r["route"]) for r in got] == [
        ([128, 64, 64, 6], [128, 256, 64, 4])]
    assert got[0]["step_delta_ms"] == pytest.approx(0.096)
    assert "1 main-path shapes at another geometry than the route's own, " \
        "1 slower by more than 2%, 0 faster" in capsys.readouterr().out
