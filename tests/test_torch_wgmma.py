"""The route to `mmad`'s tensor-core variant, pinned in pure Python.

The kernel itself runs only on the card (tests/test_torch_gpu.py); what
decides that it runs — the TMA-legality predicate `wgmma_b_major`, the
launch layout `wgmma_geometry` and `plan_launch`'s choice of variant — is
Python over shapes, dtypes, strides and alignment, so it is checked here
on CPU tensors. The last tests run gemma-2b-smoke's routed train step on
the CPU with a recorder around `mmad` and assert that every routed
forward GEMM, and every product of the backward, would take the
tensor-core variant on the card.

This file imports neither jax nor the JAX package.
"""
import dataclasses
import importlib
import math

import pytest

torch = pytest.importorskip("torch")

mmad_mod = importlib.import_module("repro_torch.kernels.mmad")

N_SMS = 132                 # an H100 SXM
SMEM_PER_BLOCK = 232448     # 227 KB a block may use


def _t(shape, dtype=torch.bfloat16):
    return torch.zeros(shape, dtype=dtype)


# ---------------------------------------------------------------------------
# the TMA-legality predicate
# ---------------------------------------------------------------------------

def _predicate_cases():
    bf, f16 = torch.bfloat16, torch.float16
    w = _t((512, 384))                      # a (K, N) weight
    embed = _t((1000, 512))                 # embed.T is (512, 1000), K-contiguous
    a = _t((64, 512))
    wide = _t((64, 520))
    return [
        ("bf16 (K, N) weight", a, w, "n"),
        ("bf16 embed.T", a, embed.T, "k"),
        ("fp16 (K, N) weight", _t((64, 512), f16), _t((512, 384), f16), "n"),
        ("fp16 embed.T", _t((64, 512), f16), _t((1000, 512), f16).T, "k"),
        ("fp32", _t((64, 512), torch.float32), _t((512, 384), torch.float32),
         None),
        ("fp8 e4m3", _t((64, 512), torch.float8_e4m3fn),
         _t((512, 384), torch.float8_e4m3fn), "n"),
        ("int8", _t((64, 512), torch.int8), _t((512, 384), torch.int8), None),
        ("fp32 A, bf16 B", _t((64, 512), torch.float32), w, None),
        ("bf16 A, fp16 B", a, _t((512, 384), f16), None),
        ("K = 130: 260-byte rows", _t((64, 130)), _t((130, 384)), None),
        ("A M-contiguous", _t((512, 64)).T, w, "n"),
        ("A M-contiguous, B K-contiguous", _t((512, 64)).T, embed.T, None),
        ("A M-contiguous, 2-byte row stride", _t((512, 65))[:, :64].T, w,
         None),
        ("A neither dim contiguous", _t((128, 1024))[:, ::2], w, None),
        ("A base 2 bytes off", wide[:, 1:513], w, None),
        ("A base 16 bytes off", wide[:, 8:520], w, "n"),
        ("B rows of 12 elements", a, _t((512, 12)), None),
        ("B rows of 8 elements", a, _t((512, 8)), "n"),
        ("B base 2 bytes off", a, _t((512, 392))[:, 1:385], None),
        ("B neither dim contiguous", a, _t((512, 768))[:, ::2], None),
        ("B rows overlap (stride 0)", a, _t((1, 384)).expand(512, 384), None),
        ("empty K", _t((64, 0)), _t((0, 384)), None),
    ]


CASES = _predicate_cases()


@pytest.mark.parametrize("name,a,b,want", CASES, ids=[c[0] for c in CASES])
def test_wgmma_b_major_is_the_tma_legality_predicate(name, a, b, want):
    """bf16 or fp16 on both sides, A K- or M-contiguous, B N- or
    K-contiguous in a pair the kernel is built for ((K, N), (K, K),
    (MN, N)), 16-byte aligned bases and 16-byte whole, non-overlapping
    rows; fp8 e4m3 on both sides likewise, on its own tensor-core
    variant (tests/test_torch_fp8.py); anything else is None (the SIMT
    tile kernel)."""
    assert mmad_mod.wgmma_b_major(a, b) == want


def test_tma_describable_reads_strides_and_alignment():
    x = _t((64, 512))
    assert mmad_mod.tma_describable(x, 1)
    assert not mmad_mod.tma_describable(x, 0)          # inner stride 512
    assert mmad_mod.tma_describable(x.T, 0)
    assert not mmad_mod.tma_describable(x[:, 4:], 1)   # 8 bytes off
    assert mmad_mod.tma_describable(x[:, 8:], 1)
    assert not mmad_mod.tma_describable(_t((64, 100)), 1)   # 200-byte rows


# ---------------------------------------------------------------------------
# wgmma_geometry at the train shapes
# ---------------------------------------------------------------------------

TRAIN = [
    # (m, n, k) -> grid: gemma-2b at batch 2 x seq 1024
    ((2048, 2048, 2048), (16, 8)),        # q, o
    ((2048, 256, 2048), (16, 1)),         # k, v
    ((2048, 16384, 2048), (16, 64)),      # gate, up
    ((2048, 2048, 16384), (16, 8)),       # down
    ((1024, 256000, 2048), (8, 1000)),    # lm_head chunk
]


@pytest.mark.parametrize("shape,grid", TRAIN,
                         ids=["qo", "kv", "gate_up", "down", "lm_head"])
def test_wgmma_geometry_at_the_train_shapes(shape, grid):
    """One CTA per 128 x 256 output tile (x over M, so consecutive CTAs
    share B), K walked in 64-deep steps through a 4-stage ring of 48 KB
    stages that fits what a block may use."""
    m, n, k = shape
    geo = mmad_mod.wgmma_geometry(m, n, k)
    assert geo.grid == grid
    assert geo.k_steps == math.ceil(k / 64)
    assert geo.stages == 4 and geo.stage_bytes == 48 * 1024
    assert geo.stages * geo.stage_bytes <= SMEM_PER_BLOCK
    # + 1 KB to align the ring for the 128-byte swizzle, + the barriers
    assert geo.smem_bytes == geo.stages * geo.stage_bytes + 1024 + 64
    assert geo.smem_bytes <= SMEM_PER_BLOCK


@pytest.mark.parametrize("m,n,k,bk", [
    (2048, 256, 2048, 512), (2048, 256, 2048, 128), (256, 512, 4096, 64),
    (200, 304, 3000, 40), (2048, 2048, 2048, 512), (64, 64, 64, 64),
    (128, 256, 100000, 96),
])
def test_wgmma_does_not_split_k(m, n, k, bk):
    """However few the tiles, the tensor-core variant walks all of K in one
    CTA per tile at every 16-bit instance (a split's fp32 partials measured
    slower than the SMs it would fill), and a plan's bk that no instance
    has is refused; the SIMT tile kernel splits by its own geometry: whole
    32-deep stages, covering K, none empty."""
    for inst in [None] + [i for i in mmad_mod.TC_INSTANCES
                          if i.family == "16bit"]:
        block = None if inst is None else (inst.bm, inst.bn, inst.bk)
        assert mmad_mod.plan_launch(m, n, k, block, N_SMS, None, 2,
                                    "k") == (mmad_mod.WGMMA, k, 1)
    if bk != mmad_mod.WGMMA_BK:
        with pytest.raises(ValueError, match="no 16bit tensor-core"):
            mmad_mod.plan_launch(m, n, k, (128, 128, bk), N_SMS, None, 2, "k")
    variant, kps, splits = mmad_mod.plan_launch(m, n, k, None, N_SMS)
    geo = mmad_mod.tile_geometry(m, n, k, 2, 2, N_SMS, False)
    assert (variant, kps, splits) == (mmad_mod.TILE, geo.kps, geo.splits)
    assert splits == 1 or kps % mmad_mod.TILE_BK == 0
    assert (splits - 1) * kps < k <= splits * kps


# ---------------------------------------------------------------------------
# plan_launch's choice of variant
# ---------------------------------------------------------------------------

ROUTES = [
    # (name, a, b, expected variant) at a train-like shape, M = 256
    ("bf16 weight", _t((256, 512)), _t((512, 384)), mmad_mod.WGMMA),
    ("bf16 embed.T", _t((256, 512)), _t((384, 512)).T, mmad_mod.WGMMA),
    ("fp16 weight", _t((256, 512), torch.float16),
     _t((512, 384), torch.float16), mmad_mod.WGMMA),
    ("fp32", _t((256, 512), torch.float32), _t((512, 384), torch.float32),
     mmad_mod.TILE, "wide"),
    ("fp8", _t((256, 512), torch.float8_e4m3fn),
     _t((512, 384), torch.float8_e4m3fn), mmad_mod.WGMMA_FP8),
    ("int8", _t((256, 512), torch.int8), _t((512, 384), torch.int8),
     mmad_mod.TILE, "wide"),
    ("mixed", _t((256, 512), torch.float32), _t((512, 384)), mmad_mod.TILE,
     "generic"),
    ("bf16 K = 130", _t((256, 130)), _t((130, 384)), mmad_mod.TILE,
     "generic"),
    # decode: a vector-loadable weight at M <= 16 keeps its stream kernel
    ("bf16 decode", _t((4, 512)), _t((512, 384)), mmad_mod.ROW_STREAM),
    ("bf16 decode embed.T", _t((4, 512)), _t((384, 512)).T,
     mmad_mod.COL_STREAM),
    # few rows whose B no stream kernel loads: tensor cores
    ("bf16 decode, 7-wide padded B", _t((4, 512)), _t((512, 8))[:, :7],
     mmad_mod.WGMMA),
    # the backward's products: da = g @ b.T, db = a.T @ g
    ("bf16 da on a weight's b.T", _t((256, 384)), _t((512, 384)).T,
     mmad_mod.WGMMA),
    ("bf16 da on embed", _t((256, 384)), _t((384, 512)), mmad_mod.WGMMA),
    ("bf16 db on a.T", _t((512, 256)).T, _t((512, 384)), mmad_mod.WGMMA),
    ("fp16 db on a.T", _t((512, 256), torch.float16).T,
     _t((512, 384), torch.float16), mmad_mod.WGMMA),
    ("bf16 a.T against a K-contiguous B", _t((512, 256)).T,
     _t((384, 512)).T, mmad_mod.TILE, "generic"),
    ("fp32 db on a.T", _t((512, 256), torch.float32).T,
     _t((512, 384), torch.float32), mmad_mod.TILE, "generic"),
]


@pytest.mark.parametrize("route", ROUTES, ids=[r[0] for r in ROUTES])
def test_plan_launch_routes_by_dtype_and_strides(route):
    """The variant, and on the SIMT tile route its instance: a vector one
    (wide here, N = 384) for one dtype with K-contiguous A and N-contiguous
    B rows on 16-byte boundaries, the generic one for mixed dtypes and
    strides or alignments that deny 16-byte vectors."""
    name, a, b, want = route[:4]
    m, k = a.shape
    n = b.shape[1]
    vector = mmad_mod.tile_vectors(a, b)
    variant, kps, splits = mmad_mod.plan_launch(
        m, n, k, None, N_SMS, mmad_mod.b_layout(b),
        b.element_size(), mmad_mod.wgmma_b_major(a, b), vector)
    assert variant == want
    assert (splits - 1) * kps < k <= splits * kps
    if want == mmad_mod.TILE:
        geo = mmad_mod.tile_geometry(m, n, k, a.element_size(),
                                     b.element_size(), N_SMS, vector)
        assert geo.instance == route[4]
        assert (geo.kps, geo.splits) == (kps, splits)


@pytest.mark.parametrize("m,n,k,block", [
    (512, 512, 512, (128, 128, 128)), (2048, 2048, 2048, (128, 128, 128)),
    (48, 192, 120, (24, 96, 40)), (4, 2048, 2048, (4, 128, 256)),
])
def test_plan_launch_defaults_to_the_simt_tile_kernel(m, n, k, block):
    """Without the routing arguments a caller gets the SIMT tile kernel's
    generic instance; with `tile_vector` the same route, split by the
    vector instance's own tiles; both refuse a block, which they have no
    geometry to run. The tensor-core major still takes precedence."""
    old = mmad_mod.plan_launch(m, n, k, None, N_SMS)
    assert old == mmad_mod.plan_launch(m, n, k, None, N_SMS, None, 2, None,
                                       False)
    geo = mmad_mod.tile_geometry(m, n, k, 2, 2, N_SMS, False)
    assert geo.instance == "generic"
    assert old == (mmad_mod.TILE, geo.kps, geo.splits)
    vec = mmad_mod.plan_launch(m, n, k, None, N_SMS, None, 2, None, True)
    geo = mmad_mod.tile_geometry(m, n, k, 2, 2, N_SMS, True)
    assert geo.instance != "generic"
    assert vec == (mmad_mod.TILE, geo.kps, geo.splits)
    for vector in (False, True):
        with pytest.raises(ValueError, match="SIMT tile route"):
            mmad_mod.plan_launch(m, n, k, block, N_SMS, None, 2, None,
                                 vector)
    assert mmad_mod.plan_launch(m, n, k, None, N_SMS, None, 2, "n")[0] == (
        mmad_mod.WGMMA)


# ---------------------------------------------------------------------------
# the train path: every routed forward GEMM would take the tensor cores
# ---------------------------------------------------------------------------

def test_every_routed_train_gemm_qualifies_for_the_tensor_cores(tmp_path,
                                                                capsys,
                                                                monkeypatch):
    """gemma-2b-smoke (bf16) takes one routed train step on the CPU with a
    recorder around `mmad`: every operand pair is bf16 on both sides, its
    strides, storage offsets and base addresses are TMA-legal, and
    `plan_launch` sends it to the tensor-core variant — so on the card no
    forward GEMM of the train step falls to the SIMT kernel (a plan whose
    `InnerKernel.dtype` widened an operand to fp32 would show here)."""
    from repro_torch.configs import smoke_config
    from repro_torch.data.pipeline import DataConfig, SyntheticLM
    from repro_torch.kernels import ops
    from repro_torch.launch import mesh, train
    from repro_torch.models import shard_ctx
    from repro_torch.models.model import init_params, make_trainable
    from repro_torch.optim import adamw
    from repro_torch.train.steps import make_train_step

    seq = 32
    cfg = dataclasses.replace(smoke_config("gemma-2b"), dtype=torch.bfloat16)
    planner = train.warm_train_plans(cfg, 2, seq, str(tmp_path), (4, 4), 12)
    params = make_trainable(init_params(torch.Generator().manual_seed(0),
                                        cfg, "cpu"))
    batch = {k: torch.from_numpy(v).long() for k, v in SyntheticLM(
        DataConfig(vocab=cfg.vocab, seq_len=seq, global_batch=2)
    ).batch(0).items()}
    seen = []
    real = ops.mmad

    def recorder(a, b, block_shape=None, out_dtype=None, stages=None):
        m, k = a.shape
        n = b.shape[1]
        major = mmad_mod.wgmma_b_major(a, b)
        # the route's own geometry: on a CUDA mesh lowering demotes these
        # TPU-view plans' inner kernels (`inner_kernel_no_instance`)
        route = mmad_mod.plan_launch(
            m, n, k, None, N_SMS, mmad_mod.b_layout(b),
            b.element_size(), major)[0]
        seen.append({"shape": (m, n, k), "dtypes": (a.dtype, b.dtype),
                     "strides": (a.stride(), b.stride()),
                     "offsets": (a.storage_offset() * a.element_size() % 16,
                                 b.storage_offset() * b.element_size() % 16),
                     "major": major, "route": route})
        return real(a, b, block_shape, out_dtype, stages)

    monkeypatch.setattr(ops, "mmad", recorder)
    ctx = shard_ctx.GemmContext(mesh=mesh.make_host_mesh("cpu"),
                                planner=planner)
    with shard_ctx.gemm_context(ctx):
        make_train_step(cfg, adamw.AdamWConfig())(
            params, adamw.init(params), None, batch)
    capsys.readouterr()
    # every forward GEMM twice (forward and remat recompute), one loss chunk
    assert len(seen) == ctx.stats.executed_gemm == 2 * (7 * cfg.n_layers + 1)
    bad = [r for r in seen if r["route"] != mmad_mod.WGMMA]
    assert not bad, bad[:3]
    for r in seen:
        assert r["dtypes"] == (torch.bfloat16, torch.bfloat16), r
        assert r["offsets"] == (0, 0), r
    majors = {r["major"] for r in seen}
    # the (K, N) weights are N-contiguous, the tied lm_head is embed.T
    assert majors == {"n", "k"}
    lm_head = [r for r in seen if r["shape"][1] == cfg.vocab]
    assert lm_head and all(r["major"] == "k" for r in lm_head)


def test_wgmma_a_major_reads_strides():
    """'k' for an activation, 'm' for its transpose, None for a view
    contiguous along neither dimension or with 16-byte-broken rows."""
    x = _t((256, 512))
    assert mmad_mod.wgmma_a_major(x) == "k"
    assert mmad_mod.wgmma_a_major(x.T) == "m"
    assert mmad_mod.wgmma_a_major(x[:, ::2]) is None
    assert mmad_mod.wgmma_a_major(_t((256, 130))) is None
    assert mmad_mod.wgmma_a_major(_t((130, 260))[:, :256].T) is None
    assert mmad_mod.wgmma_a_major(_t((130, 264))[:, :256].T) == "m"


# ---------------------------------------------------------------------------
# the backward: every product would take the tensor cores, g exactly bf16
# ---------------------------------------------------------------------------

def test_every_backward_product_qualifies_for_the_tensor_cores(
        tmp_path, capsys, monkeypatch):
    """gemma-2b-smoke (bf16) takes one routed train step on the CPU with
    `tensor_core_backward` made to ignore the device, so the backward
    calls `backward_products` as it does on the card. A recorder around
    `mmad` sees every product: bf16 on both sides, TMA-legal, sent to the
    tensor-core variant with the (A, B) majors the kernel is built for —
    da = g @ b.T as (K, K) on a (K, N) weight and (K, N) on lm_head's
    `embed`, db = a.T @ g as (MN, N). At every backward call g equals its
    bf16 rounding exactly, so rounding it loses nothing."""
    from repro_torch.configs import smoke_config
    from repro_torch.data.pipeline import DataConfig, SyntheticLM
    from repro_torch.kernels import ops
    from repro_torch.launch import mesh, train
    from repro_torch.models import shard_ctx
    from repro_torch.models.model import init_params, make_trainable
    from repro_torch.optim import adamw
    from repro_torch.train.steps import make_train_step

    seq = 32
    cfg = dataclasses.replace(smoke_config("gemma-2b"), dtype=torch.bfloat16)
    planner = train.warm_train_plans(cfg, 2, seq, str(tmp_path), (4, 4), 12)
    params = make_trainable(init_params(torch.Generator().manual_seed(0),
                                        cfg, "cpu"))
    batch = {k: torch.from_numpy(v).long() for k, v in SyntheticLM(
        DataConfig(vocab=cfg.vocab, seq_len=seq, global_batch=2)
    ).batch(0).items()}
    seen, grads = [], []
    real_mmad, real_products = ops.mmad, ops.backward_products
    state = {"backward": False}

    def recorder(a, b, block_shape=None, out_dtype=None, stages=None):
        if state["backward"]:
            m, k = a.shape
            n = b.shape[1]
            major = mmad_mod.wgmma_b_major(a, b)
            seen.append({
                "shape": (m, n, k), "dtypes": (a.dtype, b.dtype),
                "majors": (mmad_mod.wgmma_a_major(a), major),
                "out": out_dtype,
                "route": mmad_mod.plan_launch(
                    m, n, k, block_shape, N_SMS, mmad_mod.b_layout(b),
                    b.element_size(), major, stages=stages)[0]})
        return real_mmad(a, b, block_shape, out_dtype, stages)

    def products(g, a, b):
        grads.append(bool(torch.equal(g, g.bfloat16().float())))
        state["backward"] = True
        try:
            return real_products(g, a, b)
        finally:
            state["backward"] = False

    monkeypatch.setattr(ops, "mmad", recorder)
    monkeypatch.setattr(ops, "backward_products", products)
    monkeypatch.setattr(ops, "tensor_core_backward",
                        lambda a, b: a.dtype == b.dtype == torch.bfloat16)
    ctx = shard_ctx.GemmContext(mesh=mesh.make_host_mesh("cpu"),
                                planner=planner)
    with shard_ctx.gemm_context(ctx):
        make_train_step(cfg, adamw.AdamWConfig())(
            params, adamw.init(params), None, batch)
    capsys.readouterr()
    # one backward call (two products) per forward dispatch: half the
    # routed dispatches, the other half being the remat recompute
    assert len(grads) == ctx.stats.executed_gemm // 2 == 7 * cfg.n_layers + 1
    assert all(grads)
    assert len(seen) == 2 * len(grads) == ctx.stats.executed_gemm
    bad = [r for r in seen if r["route"] != mmad_mod.WGMMA]
    assert not bad, bad[:3]
    for r in seen:
        assert r["dtypes"] == (torch.bfloat16, torch.bfloat16), r
        assert r["out"] == torch.float32, r
    majors = {}
    for r in seen:
        majors.setdefault(r["majors"], set()).add(r["shape"][1] == cfg.d_model
                                                  and r["shape"][2]
                                                  == cfg.vocab)
    # da on the weights (K, K), da on lm_head's embed (K, N), db (MN, N)
    assert set(majors) == {("k", "k"), ("k", "n"), ("m", "n")}
    assert majors[("k", "n")] == {True}
    assert set(majors) <= set(mmad_mod.WGMMA_MAJORS)


@pytest.mark.parametrize("n", [13, 206, 256])
def test_backward_products_pad_gradient_rows_to_whole_16_bytes(n,
                                                               monkeypatch):
    """A tied lm_head whose vocab is not a multiple of 8 (seamless's, N =
    256,206) gives a gradient g (M, N) whose bf16 rows are not whole 16
    bytes: no TMA tensor map takes it, and both backward products would
    leave the tensor cores. `backward_products` rounds g into rows padded
    to whole 16 bytes (a view of g's shape), so both qualify, with the
    values of the unpadded products, bitwise."""
    from repro_torch.kernels import ops, ref
    g32 = torch.randn((6, n), generator=torch.Generator().manual_seed(0))
    a = torch.randn((6, 64)).bfloat16()
    embed = torch.randn((n, 64)).bfloat16()
    seen = []
    real = ops.mmad

    def recorder(x, y, *args, **kw):
        seen.append((mmad_mod.wgmma_a_major(x), mmad_mod.wgmma_b_major(x, y),
                     x.shape, y.shape))
        return real(x, y, *args, **kw)

    monkeypatch.setattr(ops, "mmad", recorder)
    da, db = ops.backward_products(g32, a, embed.T)
    g = g32.bfloat16()
    assert torch.equal(da, ref.mmad_ref(g, embed, torch.float32).bfloat16())
    assert torch.equal(db, ref.mmad_ref(a.T, g, torch.float32).bfloat16())
    assert [(s[2], s[3]) for s in seen] == [((6, n), (n, 64)),
                                            ((64, 6), (6, n))]
    assert [s[:2] for s in seen] == [("k", "n"), ("m", "n")]
    assert (n % 8 == 0) == mmad_mod.tma_describable(g, 1)
