"""fp8 e4m3 on `mmad`'s tensor-core route, pinned on the CPU, and the
paper's fp8 deployment held to the reference.

The fp8 kernel runs only on the card (tests/test_torch_gpu.py and
chip_smoke.py's `fp8 deploy` phase); what decides that it runs — the
TMA-legality predicate `wgmma_b_major`, `plan_launch`'s variant and the
launch layout `fp8_geometry` (grid, K split, scratch) — is Python over
shapes, dtypes, strides and alignment, checked here on CPU tensors, with
the geometry's constants against csrc/mmad.cu. Then the slice the card runs
for one paper shape, (64, 2112, 7168) on `softhier_gh200` at 1-byte
elements: the port's tune against the reference's, both lowerings on a 1x1
mesh, and `dit_gemm` on seeded e4m3 operands (numpy seed 27) against the
reference's jitted `dit_gemm`. Both sides sum the exact products in fp32
on the CPU and round C once to e4m3 (the mode body's `.to(a.dtype)`), so
C may differ by one e4m3 ulp where the fp32 sums, taken in another order,
straddle a rounding boundary; the test counts such elements.
"""
import importlib
import math
import re
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from jax.sharding import AxisType  # noqa: E402

from repro.core import autotuner as jtuner  # noqa: E402
from repro.core import gemm as jgemm  # noqa: E402
from repro.core import lower as jlower  # noqa: E402
from repro.core import schedule as jsched  # noqa: E402
from repro.hw import config as jhw  # noqa: E402
from repro_torch.core import autotuner as ttuner  # noqa: E402
from repro_torch.core import gemm as tgemm  # noqa: E402
from repro_torch.core import lower as tlower  # noqa: E402
from repro_torch.core import schedule as tsched  # noqa: E402
from repro_torch.hw import config as thw  # noqa: E402
from repro_torch.launch.mesh import make_host_mesh  # noqa: E402

mmad_mod = importlib.import_module("repro_torch.kernels.mmad")
N_SMS = 132                 # an H100 SXM
SMEM_PER_BLOCK = 232448     # 227 KB a block may use
F8 = torch.float8_e4m3fn
CU = Path(mmad_mod.__file__).resolve().parent / "csrc" / "mmad.cu"
PAPER = (64, 2112, 7168)    # (m, n, k): DeepSeek-V3's first flat shape
TUNE_CANDIDATES = 8         # the same winner as 48 here, in a fraction


def _t(shape, dtype=F8):
    return torch.zeros(shape, dtype=dtype)


def _padded(rows, cols, dtype=F8):
    """A (rows, cols) view of rows padded to whole 16 bytes."""
    per = 16 // _t((1,), dtype).element_size()
    return _t((rows, -(-cols // per) * per), dtype)[:, :cols]


# ---------------------------------------------------------------------------
# the route: predicate and variant
# ---------------------------------------------------------------------------

ROUTES = [
    # (name, a, b, B major, variant, SIMT instance)
    ("(K, N) weight, M = 64", _t((64, 512)), _t((512, 2112)), "n",
     mmad_mod.WGMMA_FP8, None),
    ("w.T, M = 64", _t((64, 512)), _t((2112, 512)).T, "k",
     mmad_mod.WGMMA_FP8, None),
    ("M = 17: one row past the streams", _t((17, 512)), _t((512, 2112)),
     "n", mmad_mod.WGMMA_FP8, None),
    ("M = 17, w.T", _t((17, 512)), _t((2112, 512)).T, "k",
     mmad_mod.WGMMA_FP8, None),
    ("M = 16, a row-stream weight", _t((16, 512)), _t((512, 2112)), None,
     mmad_mod.ROW_STREAM, None),
    ("M = 16, embed.T", _t((16, 512)), _t((2112, 512)).T, None,
     mmad_mod.COL_STREAM, None),
    ("M = 16, N = 8 of 16-byte rows", _t((16, 512)), _padded(512, 8), None,
     mmad_mod.TILE, "narrow16"),
    ("N = 8 of 16-byte rows", _t((64, 512)), _padded(512, 8), "n",
     mmad_mod.WGMMA_FP8, None),
    ("N = 8 contiguous: 8-byte rows", _t((64, 512)), _t((512, 8)), None,
     mmad_mod.TILE, "generic"),
    ("N = 8, w.T", _t((64, 512)), _t((8, 512)).T, "k", mmad_mod.WGMMA_FP8,
     None),
    ("N = 32768", _t((64, 512)), _t((512, 32768)), "n", mmad_mod.WGMMA_FP8,
     None),
    ("N = 32768, w.T", _t((128, 512)), _t((32768, 512)).T, "k",
     mmad_mod.WGMMA_FP8, None),
    ("K = 16", _t((4096, 16)), _t((16, 2112)), "n", mmad_mod.WGMMA_FP8,
     None),
    ("K = 16, w.T", _t((4096, 16)), _t((2112, 16)).T, "k",
     mmad_mod.WGMMA_FP8, None),
    ("K = 7168", _t((64, 7168)), _t((7168, 2112)), "n", mmad_mod.WGMMA_FP8,
     None),
    ("K = 100: 100-byte rows", _t((64, 100)), _t((100, 2112)), None,
     mmad_mod.TILE, "generic"),
    ("K = 100 in rows padded to 112", _padded(64, 100), _t((100, 2112)),
     "n", mmad_mod.WGMMA_FP8, None),
    ("K = 100, w.T: 100-byte rows", _padded(64, 100), _t((2112, 100)).T,
     None, mmad_mod.TILE, "generic"),
    ("fp8 x int8", _t((64, 512)), _t((512, 2112), torch.int8), None,
     mmad_mod.TILE, "generic"),
    ("A M-contiguous", _t((512, 64)).T, _t((512, 2112)), None,
     mmad_mod.TILE, "generic"),
    ("A base 8 bytes off", _t((64, 528))[:, 8:520], _t((512, 2112)), None,
     mmad_mod.TILE, "generic"),
    ("B base 8 bytes off", _t((64, 512)), _t((512, 2128))[:, 8:2120], None,
     mmad_mod.TILE, "generic"),
    ("bf16 keeps its kernel", _t((64, 512), torch.bfloat16),
     _t((512, 2112), torch.bfloat16), "n", mmad_mod.WGMMA, None),
]


@pytest.mark.parametrize("route", ROUTES, ids=[r[0] for r in ROUTES])
def test_fp8_route_by_dtype_rows_and_strides(route):
    """Both operands e4m3, more than `STREAM_MAX_M` rows, A K-contiguous,
    B N- or K-contiguous, 16-byte aligned bases and whole 16-byte,
    non-overlapping rows: the fp8 tensor-core variant. Up to 16 rows a
    stream kernel keeps what it loads; everything else is the SIMT tile
    route's, chosen before the launch."""
    name, a, b, major, variant, instance = route
    m, k = a.shape
    n = b.shape[1]
    assert mmad_mod.wgmma_b_major(a, b) == major
    vector = mmad_mod.tile_vectors(a, b)
    got = mmad_mod.plan_launch(m, n, k, None, N_SMS,
                               mmad_mod.b_layout(b), b.element_size(),
                               mmad_mod.wgmma_b_major(a, b), vector)
    assert got[0] == variant
    assert (got[2] - 1) * got[1] < k <= got[2] * got[1]
    if instance is not None:
        assert mmad_mod.tile_geometry(m, n, k, a.element_size(),
                                      b.element_size(), N_SMS,
                                      vector).instance == instance


# ---------------------------------------------------------------------------
# fp8_geometry
# ---------------------------------------------------------------------------

GEOMETRY = [(m, n, k, major) for m in (17, 64, 4096)
            for n in (8, 2112, 32768) for k in (16, 512, 7168)
            for major in "nk"]


@pytest.mark.parametrize("m,n,k,major", GEOMETRY)
def test_fp8_geometry_grid_split_and_scratch(m, n, k, major):
    """One CTA per 128 x bn tile, bn 128 for one M tile and 192 for more;
    K split in whole 128-deep steps only where the tiles leave SMs idle,
    into no more CTAs than one wave; a ring that fits a block; the
    scratch: a counter and a partial tile per split tile when split, then
    (N-major B) the K-major copy on a 256-byte boundary, rows of K rounded
    up to 16 bytes."""
    geo = mmad_mod.fp8_geometry(m, n, k, major, N_SMS)
    assert geo.bn == mmad_mod.fp8_tile_width(m, n, N_SMS)
    assert geo.bn == 128 or m > 128
    tiles = math.ceil(m / 128) * math.ceil(n / geo.bn)
    assert geo.grid == (math.ceil(m / 128), math.ceil(n / geo.bn),
                        geo.splits)
    assert (geo.splits - 1) * geo.kps < k <= geo.splits * geo.kps
    if geo.splits > 1:
        assert tiles < N_SMS and geo.ctas <= N_SMS
        assert geo.kps % mmad_mod.FP8_BK == 0
        assert geo.counters == tiles
        part = tiles * geo.splits * 128 * geo.bn
    else:
        assert geo.kps == k and geo.counters == 0
        assert tiles >= N_SMS or k <= mmad_mod.FP8_BK \
            or N_SMS // tiles == 1
        part = 0
    assert geo.k_steps == math.ceil(geo.kps / 128)
    assert geo.stage_bytes == (128 + geo.bn) * 128
    assert geo.smem_bytes == geo.stages * geo.stage_bytes + 1024 \
        + 16 * geo.stages
    assert geo.smem_bytes + 4 <= SMEM_PER_BLOCK       # + the `last` flag
    if major == "n":
        assert geo.transpose_grid == (math.ceil(n / mmad_mod.FP8_T_N),
                                      math.ceil(k / mmad_mod.FP8_T_K))
        assert geo.bt_offset % 64 == 0 and geo.bt_offset >= part
        assert geo.bt_row == math.ceil(k / 16) * 16
        assert geo.ws_floats * 4 >= geo.bt_offset * 4 + n * geo.bt_row
    else:
        assert geo.transpose_grid is None
        assert geo.ws_floats == part


# the paper's 18 shapes: (n, k) -> splits at M = 64 and 128 (one M tile);
# M = 4096 never splits
PAPER_SPLITS = {(2112, 7168): 7, (24576, 1536): 1, (32768, 512): 1,
                (7168, 16384): 2, (4096, 7168): 4, (7168, 2048): 2}


@pytest.mark.parametrize("nk", list(PAPER_SPLITS),
                         ids=[f"{n}x{k}" for n, k in PAPER_SPLITS])
def test_fp8_geometry_at_the_paper_shapes(nk):
    n, k = nk
    for m in (64, 128):
        geo = mmad_mod.fp8_geometry(m, n, k, "k", N_SMS)
        assert geo.splits == PAPER_SPLITS[nk] and geo.bn == 128
    big = mmad_mod.fp8_geometry(4096, n, k, "n", N_SMS)
    assert big.splits == 1 and big.grid == (32, math.ceil(n / 192), 1)


@pytest.mark.parametrize("m,n,bn", [
    (64, 32768, 128), (128, 2112, 128), (4096, 2112, 192),
    (4096, 24576, 192), (2048, 2048, 128), (256, 2112, 128),
    (4096, 7168, 192)])
def test_fp8_tile_width_by_waves(m, n, bn):
    """One M tile keeps 128 columns; more take the width whose waves of
    CTAs, over their rate, finish first: 2048 x 2048's 256 128-wide tiles
    fill 2 waves, its 176 192-wide ones 1.33."""
    assert mmad_mod.fp8_tile_width(m, n, N_SMS) == bn


def test_fp8_geometry_mirrors_the_cuda_constants():
    """kernels/mmad.py's FP8_* against csrc/mmad.cu's F8_* (edit both
    together), and the workspace offset rule against `fp8_bt_offset`."""
    src = CU.read_text()

    def const(name):
        return int(re.search(rf"\b{name} = (\d+)", src).group(1))
    assert (const("F8_BM"), const("F8_BK")) == (mmad_mod.FP8_BM,
                                                mmad_mod.FP8_BK)
    # the e4m3 rows of TC_INSTANCES: (bm, bn, bk, stages), the tile widths
    # fp8_tile_width picks from and their rings
    rows = re.findall(r"\{TC_E4M3, (\d+), (\d+), (\d+), (\d+)\}", src)
    assert [tuple(map(int, r)) for r in rows] == [
        (mmad_mod.FP8_BM, bn, mmad_mod.FP8_BK, mmad_mod.FP8_STAGES[bn])
        for bn in (mmad_mod.FP8_BN, mmad_mod.FP8_BN_FLAT)]
    assert re.search(r"F8_T_K = (\d+), F8_T_N = (\d+)", src).groups() == (
        str(mmad_mod.FP8_T_K), str(mmad_mod.FP8_T_N))
    assert "(part + 63) / 64 * 64" in src
    assert "const int inst = sub >> 8, promote = sub & 255;" in src


def test_fp8_promotion_default():
    """The tensor-core sums are promoted into fp32 every 128-deep K step
    (the readings behind it: tools/mmad_fp8_times.py, PERF.md)."""
    assert mmad_mod.FP8_PROMOTE_STEPS == 1


# ---------------------------------------------------------------------------
# the slice against the reference
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def tuned():
    """Both packages' tunes of the paper shape on `softhier_gh200`."""
    return (ttuner.tune(tsched.GEMMShape(*PAPER), thw.softhier_gh200(),
                        elem_bytes=1, max_candidates=TUNE_CANDIDATES),
            jtuner.tune(jsched.GEMMShape(*PAPER), jhw.softhier_gh200(),
                        elem_bytes=1, max_candidates=TUNE_CANDIDATES))


def test_fp8_tune_equals_the_reference(tuned):
    """The reference's schedule, down to its fp8 `InnerKernel`."""
    port, ref = tuned
    assert port.schedule.dataflow == ref.schedule.dataflow == "splitk_summa"
    assert repr(port.schedule.tiling) == repr(ref.schedule.tiling)
    assert repr(port.schedule.inner_kernel) == repr(ref.schedule.inner_kernel)
    ik = port.schedule.inner_kernel
    assert (ik.bm, ik.bn, ik.bk, ik.dtype) == (64, 66, 224, "float8_e4m3")


def _meshes():
    return (make_host_mesh("cpu"),
            jax.make_mesh((1, 1), ("data", "model"),
                          axis_types=(AxisType.Auto,) * 2))


def test_fp8_lowerings_agree_on_a_1x1_mesh(tuned):
    """On one device the split-K SUMMA plan lowers to `splitk`, the grid
    mismatch recorded as its fallback, in both packages."""
    tmesh, jmesh = _meshes()
    tep = tlower.lower_schedule(tuned[0].schedule, tmesh, shape=PAPER)
    jep = jlower.lower_schedule(tuned[1].schedule, jmesh, shape=PAPER)
    assert tep.mode == jep.mode == "splitk"
    assert tep.reasons() == jep.reasons() == ("grid_mismatch",)
    assert tep.to_dict() == jep.to_dict()


def test_fp8_dit_gemm_equals_the_reference(tuned):
    """`dit_gemm` under the tuned plan on e4m3 operands (values exact in
    e4m3, made by numpy seed 27): C in e4m3 on both sides, at most one
    e4m3 ulp apart, and only where the fp32 sum sits at a rounding
    boundary."""
    m, n, k = PAPER
    rng = np.random.default_rng(27)

    def e4m3(shape):
        x = torch.from_numpy(0.5 * rng.standard_normal(shape).astype(
            np.float32))
        return x.to(F8)
    a, b = e4m3((m, k)), e4m3((k, n))
    tmesh, jmesh = _meshes()
    got = tgemm.dit_gemm(a, b, tmesh, plan=tuned[0].schedule)
    ja = jnp.asarray(a.float().numpy()).astype(jnp.float8_e4m3fn)
    jb = jnp.asarray(b.float().numpy()).astype(jnp.float8_e4m3fn)
    want = jax.jit(lambda x, y: jgemm.dit_gemm(
        x, y, jmesh, plan=tuned[1].schedule))(ja, jb)
    assert got.dtype == F8 and want.dtype == jnp.float8_e4m3fn
    got32 = got.float().numpy()
    want32 = np.asarray(want.astype(jnp.float32))
    assert np.isfinite(got32).all() and np.isfinite(want32).all()
    low = np.minimum(np.abs(got32), np.abs(want32))
    ulp = np.exp2(np.maximum(np.floor(np.log2(np.maximum(low, 2.0 ** -9))),
                             -6) - 3)
    assert (np.abs(got32 - want32) <= ulp).all()
    differ = int((got32 != want32).sum())
    assert differ <= 0.01 * got32.size, differ
    # the exact sum rounded once agrees too
    exact = (a.double() @ b.double()).float().to(F8).float().numpy()
    assert (np.abs(got32 - exact) <= ulp).all()
