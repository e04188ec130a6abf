"""Parity of the PyTorch port's kernel layer with the JAX reference.

Inputs are made with numpy from fixed seeds and fed to both packages:

- the `mmad` plain version (what the port runs for CPU tensors, and what
  the CUDA kernel is held against on the card) vs the reference's Pallas
  `mmad` in interpret mode, over every input dtype and several block
  geometries, power of two or not;
- `tile_matmul` on ragged shapes and a transposed-B view vs the
  reference's padded-then-sliced result;
- `pick_block_shape`, `block_for` and the `_cast_operand` rules, case by
  case;
- `local_matmul` forward and grads vs the reference's `local_matmul`.

Tolerances: both sides accumulate fp32 products of identical fp32-exact
operands, so they differ only in summation order — rtol 1e-5 and atol
1e-5·sqrt(K) on unit-normal inputs, plus one output ulp when the output is
bf16 or fp16.
"""
import importlib
import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import ml_dtypes  # noqa: E402

from repro.core.schedule import InnerKernel as JInnerKernel  # noqa: E402
from repro.kernels import ops as jops  # noqa: E402
from repro_torch.core.schedule import InnerKernel  # noqa: E402
from repro_torch.kernels import ops as tops  # noqa: E402
from repro_torch.kernels import ref as tref  # noqa: E402

# the packages re-export the `mmad` function under the module's name
jmmad_mod = importlib.import_module("repro.kernels.mmad")
tmmad_mod = importlib.import_module("repro_torch.kernels.mmad")

# schedule dtype name -> (numpy storage dtype, jnp dtype, torch dtype)
DTYPES = {
    "float32": (np.float32, jnp.float32, torch.float32),
    "bfloat16": (ml_dtypes.bfloat16, jnp.bfloat16, torch.bfloat16),
    "float16": (np.float16, jnp.float16, torch.float16),
    "float8_e4m3": (ml_dtypes.float8_e4m3fn, jnp.float8_e4m3fn,
                    torch.float8_e4m3fn),
    "int8": (np.int8, jnp.int8, torch.int8),
}
# one unit in the last place, relative to the value: at most 2^-7 for bf16
# (8 significant bits) and 2^-10 for fp16 (11)
ULP = {torch.float32: 0.0, torch.bfloat16: 2.0 ** -7,
       torch.float16: 2.0 ** -10}


def operands(m, k, n, dtype_name, seed):
    """Values exactly representable in `dtype_name`, as (numpy storage
    array, fp32 copy) for A and B. int8 draws small integers."""
    npdt = DTYPES[dtype_name][0]
    rng = np.random.default_rng(seed)
    out = []
    for shape in ((m, k), (k, n)):
        if dtype_name == "int8":
            raw = rng.integers(-8, 9, shape).astype(np.int8)
        else:
            raw = rng.standard_normal(shape).astype(np.float32).astype(npdt)
        out.append((raw, raw.astype(np.float32)))
    return out


def to_jax(raw, dtype_name):
    return jnp.asarray(raw, DTYPES[dtype_name][1])


def to_torch(raw, dtype_name):
    # through fp32, which every supported dtype converts to exactly
    return torch.from_numpy(raw.astype(np.float32)).to(DTYPES[dtype_name][2])


def assert_close(got, want, k, out_dtype=torch.float32):
    got = np.asarray(got, np.float32)
    want = np.asarray(want, np.float32)
    atol = 1e-5 * math.sqrt(k) + ULP[out_dtype] * np.abs(want)
    np.testing.assert_allclose(got, want, rtol=1e-5 + ULP[out_dtype],
                               atol=float(np.max(atol)))


# ---------------------------------------------------------------------------
# mmad: plain version vs the Pallas kernel (interpret mode)
# ---------------------------------------------------------------------------

GEOMETRIES = [
    # (m, k, n, block) — decode geometries, a square one, non-powers of two
    (8, 512, 256, (4, 128, 256)),
    (4, 512, 1024, (4, 512, 256)),
    (8, 1024, 256, (4, 128, 512)),
    (4, 256, 256, (2, 256, 128)),
    (128, 256, 256, (128, 128, 128)),
    (48, 120, 192, (24, 96, 40)),
]


@pytest.mark.parametrize("dtype_name", sorted(DTYPES))
@pytest.mark.parametrize("geom", GEOMETRIES,
                         ids=["x".join(map(str, g[3])) for g in GEOMETRIES])
def test_mmad_plain_matches_pallas(dtype_name, geom):
    m, k, n, block = geom
    (a_raw, _), (b_raw, _) = operands(m, k, n, dtype_name, seed=m + n + k)
    want = jmmad_mod.mmad(to_jax(a_raw, dtype_name), to_jax(b_raw, dtype_name),
                          block_shape=block, interpret=True,
                          out_dtype=jnp.float32)
    got = tmmad_mod.mmad(to_torch(a_raw, dtype_name),
                         to_torch(b_raw, dtype_name), block_shape=block,
                         out_dtype=torch.float32)
    assert got.dtype == torch.float32 and tuple(got.shape) == (m, n)
    assert_close(got, want, k)


@pytest.mark.parametrize("out_name", ["bfloat16", "float16"])
def test_mmad_plain_narrow_output_matches_pallas(out_name):
    m, k, n, block = 8, 512, 256, (4, 128, 256)
    (a_raw, _), (b_raw, _) = operands(m, k, n, "bfloat16", seed=7)
    want = jmmad_mod.mmad(to_jax(a_raw, "bfloat16"), to_jax(b_raw, "bfloat16"),
                          block_shape=block, interpret=True,
                          out_dtype=DTYPES[out_name][1])
    out_dtype = DTYPES[out_name][2]
    got = tmmad_mod.mmad(to_torch(a_raw, "bfloat16"),
                         to_torch(b_raw, "bfloat16"), block_shape=block,
                         out_dtype=out_dtype)
    assert got.dtype == out_dtype
    assert_close(got.float(), np.asarray(want, np.float32), k, out_dtype)


def test_mmad_default_out_dtype_is_input_dtype():
    (a_raw, _), (b_raw, _) = operands(8, 128, 128, "bfloat16", seed=1)
    out = tmmad_mod.mmad(to_torch(a_raw, "bfloat16"), to_torch(b_raw, "bfloat16"))
    assert out.dtype == torch.bfloat16


def test_mmad_rejects_non_cpu_non_cuda_tensors():
    """The plain version runs only for CPU tensors, and meta operands on
    both sides (the dry run's shape-only trace) give an empty meta product
    and launch nothing: anything else must launch the kernel or raise —
    here a meta operand beside a CPU one raises."""
    a = torch.empty((4, 8), device="meta")
    b = torch.empty((8, 4), device="meta")
    with pytest.raises(ValueError, match="CUDA device"):
        tmmad_mod.mmad(a, torch.zeros(8, 4))
    with pytest.raises(ValueError, match="CUDA device"):
        tmmad_mod.mmad(torch.zeros(4, 8), b)
    launches = tmmad_mod._launches
    out = tmmad_mod.mmad(a, b, out_dtype=torch.float32)
    assert (out.device.type, out.shape, out.dtype) == \
        ("meta", (4, 4), torch.float32)
    assert tmmad_mod._launches == launches
    with pytest.raises(ValueError, match="inner dims"):
        tmmad_mod.mmad(torch.zeros(4, 8), torch.zeros(7, 4))
    with pytest.raises(ValueError, match="block shape"):
        tmmad_mod.mmad(torch.zeros(4, 8), torch.zeros(8, 4), (0, 1, 1))


def test_mmad_cpu_path_does_not_count_launches():
    tmmad_mod.reset_launch_count()
    tmmad_mod.mmad(torch.ones(4, 8), torch.ones(8, 4))
    assert tmmad_mod.launch_count() == 0


@pytest.mark.parametrize("m,n,k,block,vector,expect", [
    # operands no stream kernel loads, on 132 SMs: (variant, k per split,
    # splits), the generic instance (64 x 64 tiles) or, with 4-byte
    # operands the vector instances read, the wide one (128 x 128)
    (4, 2048, 2048, (4, 128, 256), False, (0, 256, 8)),
    (4, 256, 2048, (4, 256, 128), True, (0, 32, 64)),     # a split per stage
    (4, 16384, 2048, (4, 512, 256), False, (0, 2048, 1)),
    (4, 2048, 16384, (4, 128, 512), True, (0, 2048, 8)),
    (4, 256000, 2048, (4, 512, 256), True, (0, 2048, 1)),
    (512, 512, 512, (128, 128, 128), False, (0, 128, 4)),
    (2048, 2048, 2048, (128, 128, 128), True, (0, 2048, 1)),
    (48, 192, 120, (24, 96, 40), False, (0, 32, 4)),      # non-power-of-two bk
])
def test_plan_launch_tiles_split_k_in_whole_blocks(m, n, k, block, vector,
                                                   expect):
    """Operands the stream kernels cannot vector-load take the tile kernel,
    its K split in whole 32-deep stages chosen from the shape and the SM
    count: the splits cover K exactly, none is empty; a plan's block (its
    bk included) is refused, since the tile route runs no plan geometry."""
    got = tmmad_mod.plan_launch(m, n, k, None, n_sms=132, elem_bytes=4,
                                tile_vector=vector)
    assert got == expect
    variant, kps, splits = got
    assert splits == 1 or kps % tmmad_mod.TILE_BK == 0
    assert (splits - 1) * kps < k <= splits * kps
    with pytest.raises(ValueError, match="SIMT tile route"):
        tmmad_mod.plan_launch(m, n, k, block, n_sms=132, elem_bytes=4,
                              tile_vector=vector)


@pytest.mark.parametrize("m,n,k,layout,expect", [
    # gemma-2b decode shapes, bf16, on 132 SMs: (variant, k per split, splits)
    (4, 2048, 2048, "rows", (1, 416, 5)),       # q, o: 32 tiles x 5
    (4, 256, 2048, "rows", (1, 56, 37)),        # k, v: 4 tiles x 37
    (4, 16384, 2048, "rows", (1, 2048, 1)),     # gate, up: 256 tiles
    (4, 2048, 16384, "rows", (1, 2048, 8)),     # down: A staged at most 2048 k
    (4, 256000, 2048, "cols", (2, 2048, 1)),    # lm_head: C written directly
    (4, 270336, 512, "rows", (1, 512, 1)),      # many tiles: no split
    (4, 256, 2048, "cols", (2, 688, 3)),        # few columns: K splits
    (16, 2048, 2048, "rows", (1, 1024, 2)),     # 4 groups of 4 rows x 32 tiles
    (17, 2048, 2048, "rows", (0, 256, 8)),      # too many rows: tile kernel
                                                # (generic: no tile_vector)
])
def test_plan_launch_streams_decode_shapes(m, n, k, layout, expect):
    got = tmmad_mod.plan_launch(m, n, k, None, n_sms=132,
                                layout=layout, elem_bytes=2)
    assert got == expect
    variant, kps, splits = got
    assert (splits - 1) * kps < k <= splits * kps


DECODE_SHAPES = [
    # (m, n, k, B layout): gemma-2b at batch 4
    (4, 2048, 2048, "rows"), (4, 256, 2048, "rows"), (4, 16384, 2048, "rows"),
    (4, 2048, 16384, "rows"), (4, 256000, 2048, "cols"),
]


@pytest.mark.parametrize("elem_bytes", [4, 2, 1], ids=["b32", "b16", "b8"])
@pytest.mark.parametrize("shape", DECODE_SHAPES,
                         ids=["qo", "kv", "gate_up", "down", "lm_head"])
def test_stream_geometry_fills_the_card(shape, elem_bytes):
    """Every decode shape puts at least one CTA on each of the 132 SMs,
    fits one CTA's shared memory (227 KB), keeps at least 32 KB of the
    weight requested per busy SM, and splits K no more than it must."""
    m, n, k, layout = shape
    geo = tmmad_mod.stream_geometry(m, n, k, layout, elem_bytes, 132)
    assert geo.ctas >= 132
    assert geo.smem_bytes <= 232448
    # the resident CTAs' shared memory fits the SM's 228 KB, 1 KB each reserved
    assert geo.ctas_per_sm * (geo.smem_bytes + 1024) <= 233472
    assert geo.inflight_bytes_per_sm(132) >= 32 * 1024
    assert (geo.splits - 1) * geo.kps < k <= geo.splits * geo.kps
    vec = 16 // elem_bytes
    if layout == "rows":
        tiles = math.ceil(n / (vec * tmmad_mod.ROW_VECS))
        unit, cap = tmmad_mod.ROW_UNIT, tmmad_mod.ROW_MAX_KPS
        assert geo.grid == (tiles, 1, geo.splits)
        assert geo.counters == (tiles if geo.splits > 1 else 0)
        # the rows kernel's shared memory stays in the default 48 KB
        assert geo.smem_bytes <= 49152
    else:
        tiles = math.ceil(n / tmmad_mod.STREAM_COLS)
        unit, cap = vec, tmmad_mod.COL_MAX_KPS
        assert geo.counters == (0 if geo.splits == 1 else tiles)
    assert geo.kps % unit == 0 and geo.kps <= cap
    assert geo.ws_floats == (0 if geo.splits == 1 else geo.splits * m * n)
    if geo.splits > 1:       # one split fewer would leave SMs idle
        kps = math.ceil(math.ceil(k / unit) / (geo.splits - 1)) * unit
        assert tiles * math.ceil(k / kps) < 132 or kps > cap


@pytest.mark.parametrize("tiles,k,unit,cap", [
    (32, 2048, 8, 2048), (4, 2048, 8, 2048), (256, 2048, 8, 2048),
    (32, 16384, 8, 2048), (1, 64, 8, 2048), (64, 2048, 8, 2048),
])
def test_fewest_splits_is_the_least_that_fills_the_card(tiles, k, unit, cap):
    """Against a search over every split count: the fewest splits, each a
    whole number of units of at most `cap` k, that give at least 132
    CTAs; every unit its own split when none does."""
    kps, splits = tmmad_mod._fewest_splits(tiles, k, unit, cap, 132)
    n_units = math.ceil(k / unit)
    ok = []
    for s in range(1, n_units + 1):
        per = math.ceil(n_units / s) * unit
        if tiles * math.ceil(k / per) >= 132 and per <= cap:
            ok.append((math.ceil(k / per), per))
    assert (splits, kps) == (min(ok) if ok else (n_units, unit))
    assert (splits - 1) * kps < k <= splits * kps


def test_b_layout_picks_the_vector_loadable_dim():
    w = torch.zeros(64, 48, dtype=torch.bfloat16)
    assert tmmad_mod.b_layout(w) == "rows"
    assert tmmad_mod.b_layout(torch.zeros(48, 64, dtype=torch.bfloat16).T) == "cols"
    assert tmmad_mod.b_layout(torch.zeros(64, 50, dtype=torch.bfloat16)) is None
    assert tmmad_mod.b_layout(w[:, 1:9]) is None          # misaligned start
    assert tmmad_mod.b_layout(w[::2]) == "rows"


# ---------------------------------------------------------------------------
# tile_matmul / pick_block_shape / block_for / _cast_operand
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("m,k,n", [(5, 130, 7), (100, 128, 128), (33, 257, 65)])
def test_tile_matmul_ragged_matches_padded_reference(m, k, n):
    (a_raw, _), (b_raw, _) = operands(m, k, n, "float32", seed=m * n)
    want = jops.tile_matmul(to_jax(a_raw, "float32"), to_jax(b_raw, "float32"),
                            interpret=True, use_kernel=True)
    got = tops.tile_matmul(to_torch(a_raw, "float32"),
                           to_torch(b_raw, "float32"))
    assert tuple(got.shape) == (m, n)
    assert_close(got, want, k)


def test_tile_matmul_transposed_b_view():
    """The tied lm_head weight is embed.T: a strided view, not a copy."""
    (a_raw, _), (e_raw, _) = operands(6, 96, 200, "bfloat16", seed=3)
    embed_t = to_torch(e_raw, "bfloat16").T.contiguous()      # (200, 96)
    b_view = embed_t.T                                        # (96, 200) view
    assert not b_view.is_contiguous()
    want = jops.tile_matmul(to_jax(a_raw, "bfloat16"),
                            to_jax(e_raw, "bfloat16"), block_shape=(8, 128, 32),
                            interpret=True, use_kernel=True,
                            out_dtype=jnp.float32)
    got = tops.tile_matmul(to_torch(a_raw, "bfloat16"), b_view,
                           block_shape=(8, 128, 32), out_dtype=torch.float32)
    assert_close(got, want, 96)


@pytest.mark.parametrize("m,n,k,eb", [
    (1, 1, 1, 4), (4, 2048, 2048, 2), (4, 256000, 2048, 2), (128, 384, 256, 4),
    (100, 100, 100, 1), (7, 1000, 5000, 2), (512, 512, 8192, 4),
])
def test_pick_block_shape_matches_reference(m, n, k, eb):
    assert tops.pick_block_shape(m, n, k, eb) == jops.pick_block_shape(m, n, k, eb)


@pytest.mark.parametrize("kernel", [None, InnerKernel(8, 128, 32),
                                    InnerKernel(128, 256, 64, depth=4,
                                                dtype="float32")],
                         ids=["no-kernel", "8x128x32", "128x256x64-fp32"])
def test_block_for_is_the_kernels_geometry_or_the_picked_block(kernel):
    """The one rule for the block `local_matmul` hands `mmad`: a plan's
    inner kernel's geometry with its depth as the ring's stages, else none,
    for `mmad`'s route to pick (the reference's `pick_block_shape` picks a
    Pallas block there, which no CUDA launch reads)."""
    if kernel is None:
        assert tops.block_for(kernel) == (None, None)
        return
    jkernel = JInnerKernel(kernel.bm, kernel.bn, kernel.bk,
                           depth=kernel.depth, dtype=kernel.dtype)
    # the block the reference's local_matmul runs its Pallas kernel at
    assert tops.block_for(kernel) == (jkernel.geometry(), jkernel.depth)


CAST_CASES = [(have, want) for have in sorted(DTYPES)
              for want in sorted(DTYPES) + [""]]


@pytest.mark.parametrize("have,want", CAST_CASES,
                         ids=[f"{h}->{w or 'inherit'}" for h, w in CAST_CASES])
def test_cast_operand_matches_reference(have, want):
    """Never narrow, never cross float/int: the resulting dtype of every
    (data dtype, kernel dtype) pair equals the reference's."""
    raw = np.zeros((2, 2), DTYPES[have][0])
    jout = jops._cast_operand(to_jax(raw, have), JInnerKernel(8, 8, 8, dtype=want))
    tout = tops._cast_operand(to_torch(raw, have), InnerKernel(8, 8, 8, dtype=want))
    names = {v[2]: k for k, v in DTYPES.items()}
    jnames = {jnp.dtype(v[1]): k for k, v in DTYPES.items()}
    assert names[tout.dtype] == jnames[jnp.dtype(jout.dtype)]


# ---------------------------------------------------------------------------
# local_matmul forward + grads
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("data,kernel_dtype", [
    ("float32", "float32"), ("bfloat16", "bfloat16"), ("bfloat16", "float32"),
    ("float32", "float8_e4m3"),
])
def test_local_matmul_forward_and_grads_match_reference(data, kernel_dtype):
    m, k, n = 24, 160, 40
    (a_raw, _), (b_raw, _) = operands(m, k, n, data, seed=11)
    g = np.random.default_rng(12).standard_normal((m, n)).astype(np.float32)
    jk = JInnerKernel(8, 128, 32, dtype=kernel_dtype)
    tk = InnerKernel(8, 128, 32, dtype=kernel_dtype)

    ja, jb = to_jax(a_raw, data), to_jax(b_raw, data)
    jout, vjp = jax.vjp(lambda x, y: jops.local_matmul(x, y, jk), ja, jb)
    jga, jgb = vjp(jnp.asarray(g))

    ta = to_torch(a_raw, data).requires_grad_(True)
    tb = to_torch(b_raw, data).requires_grad_(True)
    tout = tops.local_matmul(ta, tb, tk)
    tout.backward(torch.from_numpy(g))

    assert tout.dtype == torch.float32
    assert_close(tout.detach(), jout, k)
    assert ta.grad.dtype == ta.dtype and tb.grad.dtype == tb.dtype
    out_dt = DTYPES[data][2]
    assert_close(ta.grad.float(), np.asarray(jga, np.float32), n, out_dt)
    assert_close(tb.grad.float(), np.asarray(jgb, np.float32), m, out_dt)


def test_splitk_and_flash_refs_match_reference():
    from repro.kernels import ref as jref
    (a_raw, _), (b_raw, _) = operands(16, 64, 24, "float32", seed=5)
    assert_close(tref.splitk_ref(to_torch(a_raw, "float32"),
                                 to_torch(b_raw, "float32"), 4),
                 jref.splitk_ref(to_jax(a_raw, "float32"),
                                 to_jax(b_raw, "float32"), 4), 64)
    rng = np.random.default_rng(6)
    q, kk, v = (rng.standard_normal((2, s, 32)).astype(np.float32)
                for s in (5, 9, 9))
    want = jref.flash_attention_ref(jnp.asarray(q), jnp.asarray(kk),
                                    jnp.asarray(v), causal=True)
    got = tref.flash_attention_ref(torch.from_numpy(q), torch.from_numpy(kk),
                                   torch.from_numpy(v), causal=True)
    assert_close(got, want, 32)
