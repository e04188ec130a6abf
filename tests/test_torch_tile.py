"""The SIMT tile route of `mmad`, pinned in pure Python.

The kernel runs only on the card (tests/test_torch_gpu.py); what decides
how it runs — the vector-load predicate `tile_vectors`, the instance and
split `tile_geometry` gives, and `plan_launch` returning that split — is
Python over shapes, dtypes, strides and alignment, so it is checked here on
CPU tensors: the on-path fp32 shapes (deepseek-moe-16b's train router,
xlstm-1.3b's gates), the record shapes, the generic instance's inputs, the
split rule against a search over every split count, and the instance table
against the one in csrc/mmad.cu.

This file imports neither jax nor the JAX package.
"""
import importlib
import math
import re
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

mmad_mod = importlib.import_module("repro_torch.kernels.mmad")

N_SMS = 132                 # an H100 SXM
SMEM_PER_BLOCK = 232448     # 227 KB a block may use
SMEM_PER_SM = 233472        # 228 KB, 1 KB of it reserved per resident block
CU = (Path(mmad_mod.__file__).resolve().parent / "csrc" / "mmad.cu")


def _t(shape, dtype=torch.float32):
    return torch.zeros(shape, dtype=dtype)


# (name, m, n, k, element bytes, instance): the main path's fp32 GEMMs on
# the route, and the record shapes timed beside them
SHAPES = [
    ("moe.router train", 2048, 64, 2048, 4, "narrow64"),
    ("mlstm.gates train", 2048, 8, 2048, 4, "narrow8"),
    ("mlstm.gates forward", 512, 8, 2048, 4, "narrow8"),
    ("wide fp32", 2048, 2048, 2048, 4, "wide"),
    ("wide fp8", 2048, 2048, 2048, 1, "wide"),
    ("fp8 at N = 8", 2048, 8, 2048, 1, "narrow16"),
    ("bf16 at N = 24", 300, 24, 1000, 2, "narrow32"),
]


@pytest.mark.parametrize("shape", SHAPES, ids=[s[0] for s in SHAPES])
def test_tile_geometry_at_the_path_and_record_shapes(shape):
    """The instance by N (narrow up to 64 columns, a tile as wide as N
    rounded up to a power of two and at least one 16-byte chunk of B; wide
    past that), CTAs that fill the SMs' resident slots (or a split per
    stage where K has too few), splits that cover K in whole 32-deep
    stages with none empty, shared memory that fits a block and the CTAs
    `__launch_bounds__` asks to keep resident, and scratch for one counter
    and `splits` partial tiles per output tile."""
    _, m, n, k, size, instance = shape
    geo = mmad_mod.tile_geometry(m, n, k, size, size, N_SMS)
    cfg = mmad_mod.TILE_CONFIGS[instance]
    assert geo.instance == instance and geo.code == cfg.code
    assert geo.grid == (math.ceil(n / cfg.bn), math.ceil(m / cfg.bm),
                        geo.splits)
    tiles = geo.grid[0] * geo.grid[1]
    slots = N_SMS * cfg.min_ctas
    assert geo.ctas >= min(0.9 * slots,
                           tiles * math.ceil(k / mmad_mod.TILE_BK))
    assert (geo.splits - 1) * geo.kps < k <= geo.splits * geo.kps
    assert geo.splits == 1 or geo.kps % mmad_mod.TILE_BK == 0
    assert geo.smem_bytes <= SMEM_PER_BLOCK
    assert cfg.min_ctas * (geo.smem_bytes + 1024) <= SMEM_PER_SM
    if geo.splits > 1:
        assert geo.counters == tiles
        assert geo.ws_floats == tiles * geo.splits * cfg.bm * cfg.bn
    else:
        assert geo.counters == geo.ws_floats == 0
    assert mmad_mod.plan_launch(m, n, k, None, N_SMS, None, size,
                                None, True) == (mmad_mod.TILE, geo.kps,
                                                geo.splits)


def test_the_on_path_shapes_fill_the_card_without_masked_columns():
    """The router's 64 columns and the gates' 8 take tiles exactly as wide
    as N, and K splits by the SMs' slots, not by the plan's bk: the router
    (its instance at up to 255 registers, one CTA an SM) 4 ways, 128 CTAs
    with 512 k each; the gates (two CTAs an SM, to keep more of A in
    flight) 8 ways, 256 CTAs. The wide record shape fills two waves of
    one CTA an SM unsplit."""
    for n, instance, splits in ((64, "narrow64", 4), (8, "narrow8", 8)):
        geo = mmad_mod.tile_geometry(2048, n, 2048, 4, 4, N_SMS)
        assert geo.instance == instance
        assert mmad_mod.TILE_CONFIGS[instance].bn == n
        assert (geo.grid, geo.kps, geo.splits) == (
            (1, 32, splits), 2048 // splits, splits)
        assert geo.ctas == 128 * mmad_mod.TILE_CONFIGS[instance].min_ctas
    wide = mmad_mod.tile_geometry(2048, 2048, 2048, 4, 4, N_SMS)
    assert (wide.grid, wide.splits) == ((16, 16, 1), 1)


GENERIC = [
    # (name, a, b): what the vector instances do not read
    ("bf16 K = 130", _t((256, 130), torch.bfloat16),
     _t((130, 384), torch.bfloat16)),
    ("mixed fp32 x bf16", _t((256, 512)), _t((512, 384), torch.bfloat16)),
    ("mixed bf16 x fp16", _t((256, 512), torch.bfloat16),
     _t((512, 384), torch.float16)),
    ("fp32 a.T", _t((512, 256)).T, _t((512, 384))),
    ("fp32 embed.T", _t((256, 512)), _t((384, 512)).T),
    ("fp32 B misaligned", _t((256, 512)), _t((512, 385))[:, 1:]),
    ("fp32 A row of 4 bytes", _t((256, 1)), _t((1, 384))),
    ("fp8 K = 8", _t((256, 8), torch.float8_e4m3fn),
     _t((8, 64), torch.float8_e4m3fn)),
]
VECTOR = [
    ("fp32", _t((2048, 2048)), _t((2048, 64))),
    ("fp32 N = 8", _t((2048, 2048)), _t((2048, 8))),
    ("fp8", _t((256, 512), torch.float8_e4m3fn),
     _t((512, 384), torch.float8_e4m3fn)),
    ("int8", _t((256, 512), torch.int8), _t((512, 384), torch.int8)),
    ("bf16 column slice", _t((256, 520), torch.bfloat16)[:, 8:],
     _t((512, 384), torch.bfloat16)),
]


@pytest.mark.parametrize("case", GENERIC + VECTOR,
                         ids=[c[0] for c in GENERIC + VECTOR])
def test_tile_vectors_picks_the_instance_from_dtypes_and_strides(case):
    """One dtype, K-contiguous A rows and N-contiguous B rows on 16-byte
    boundaries take a vector instance; anything else the generic one,
    chosen before the launch and never after a failed one."""
    name, a, b = case
    want = case in VECTOR
    assert mmad_mod.tile_vectors(a, b) is want
    m, k = a.shape
    n = b.shape[1]
    geo = mmad_mod.tile_geometry(m, n, k, a.element_size(), b.element_size(),
                                 N_SMS, want)
    assert (geo.instance == "generic") is not want


def test_vector_instances_take_one_dtype():
    with pytest.raises(ValueError, match="one dtype"):
        mmad_mod.tile_geometry(256, 384, 512, 4, 2, N_SMS, True)


@pytest.mark.parametrize("per_sm", [1, 2])
@pytest.mark.parametrize("tiles,k", [
    (32, 2048), (16, 2048), (8, 2048), (256, 2048), (1, 130), (2, 120),
    (6, 300), (2, 100000), (3, 32), (2048, 2048),
])
def test_balanced_splits_is_the_fewest_near_an_even_share(tiles, k, per_sm):
    """Against a search over every split count, each cut as evenly as
    whole 32-deep stages allow: the split covers K with none empty, leaves
    its busiest SM (waves of `per_sm` CTAs an SM, each `kps` deep) within
    `SPLIT_SLACK` of an even share (or of the best split, where none comes
    that close), and no split count below it does."""
    unit = mmad_mod.TILE_BK
    kps, splits = mmad_mod._balanced_splits(tiles, k, unit, N_SMS, per_sm)
    assert kps % unit == 0 and (splits - 1) * kps < k <= splits * kps
    n_units = math.ceil(k / unit)
    slots = N_SMS * per_sm
    options = {}
    for want in range(1, n_units + 1):
        cut = math.ceil(n_units / want) * unit
        s = math.ceil(k / cut)
        load = math.ceil(tiles * s / slots) * cut
        options[s] = min(load, options.get(s, load))
    target = max(tiles * k / slots, min(options.values()))
    fits = [s for s, load in options.items()
            if load <= (1 + mmad_mod.SPLIT_SLACK) * target]
    assert splits == min(fits)


def test_instance_table_mirrors_the_kernel_source():
    """kernels/mmad.py's TILE_CONFIGS, TILE_THREADS and TILE_BK are the
    csrc/mmad.cu table the launcher and kernel are built from."""
    src = CU.read_text()
    assert re.search(r"constexpr int TILE_NT = (\d+);", src).group(1) == str(
        mmad_mod.TILE_THREADS)
    assert re.search(r"constexpr int TILE_BK = (\d+);", src).group(1) == str(
        mmad_mod.TILE_BK)
    table = src[src.index("constexpr TileCfg TILE_CFGS[] = {"):]
    table = table[:table.index("};")]
    rows = [tuple(int(x) for x in m.groups()) for m in re.finditer(
        r"\{(\d+), (\d+), (\d+), (\d+), (\d+), (\d+), (\d+)\}", table)]
    by_code = sorted(mmad_mod.TILE_CONFIGS.values())
    assert rows == [tuple(c[1:]) for c in by_code]
    assert [c.code for c in by_code] == list(range(len(rows)))
    for cfg in by_code:
        tx, ry = cfg.bn // cfg.tn, cfg.bm // cfg.tm
        assert tx * ry * cfg.k_slices == mmad_mod.TILE_THREADS
        assert (mmad_mod.TILE_BK // cfg.k_slices) % 4 == 0


INSTANCES = [(name, size) for name, cfg in sorted(mmad_mod.TILE_CONFIGS.items())
             for size in (4, 2, 1)
             if not name.startswith("narrow") or cfg.bn * size >= 16]


@pytest.mark.parametrize("instance,size", INSTANCES,
                         ids=[f"{n}-b{s}" for n, s in INSTANCES])
def test_every_instance_fits_its_resident_ctas(instance, size):
    """Ring or slice sums, whichever is larger, within what a block may use
    and, times the CTAs `__launch_bounds__` keeps resident, within the SM
    (the generic instance stages fp32 whatever the operands). A narrow
    tile's B row is at least one 16-byte chunk, so 1-byte operands have
    no 8-wide instance."""
    cfg = mmad_mod.TILE_CONFIGS[instance]
    vector = instance != "generic"
    n = cfg.bn if instance.startswith("narrow") else 4096
    geo = mmad_mod.tile_geometry(4096, n, 4096, size, size, N_SMS, vector)
    assert geo.instance == instance
    assert geo.smem_bytes <= SMEM_PER_BLOCK
    assert cfg.min_ctas * (geo.smem_bytes + 1024) <= SMEM_PER_SM
