"""On-card tests of the port's CUDA kernel (marker `gpu`).

Each test asks the `cuda` fixture for the card and skips, with its reason,
where there is none (the CPU test run). On an H100 they build `mmad` from
`src/repro_torch/kernels/csrc/mmad.cu` and hold it against its plain
version on the same tensors: rtol 1e-5 and atol 1e-5·sqrt(K) (fp32
accumulation of fp32-exact products in another order), plus one output ulp
for bf16 out. The tensor-core variant's sums are taken by the tensor cores,
which truncate the fp32 running sum at each 16-deep K slice, so its cases
add `tensor_core_atol` (chip_smoke.py says how it was set). Run them on
the card with

    PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_gpu.py

This file imports neither jax nor the JAX package.
"""
import importlib
import math
import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")

pytestmark = pytest.mark.gpu

mmad_mod = importlib.import_module("repro_torch.kernels.mmad")
from repro_torch.kernels import ops, ref  # noqa: E402
from repro_torch.core.schedule import InnerKernel  # noqa: E402


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card; on a GPU host run: PYTHONPATH=src "
                    "python -m pytest -m gpu tests/test_torch_gpu.py")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


DTYPES = ["float32", "bfloat16", "float16", "float8_e4m3fn", "int8"]
GEOMETRIES = [
    # (m, k, n, block, transposed B): the stream kernels and the SIMT tile
    # route run their own geometry, so no block is named
    (4, 2048, 2048, None, False),           # row stream, split K
    (4, 2048, 256, None, False),
    (4, 4096, 512, None, False),
    (4, 2048, 3000, None, True),            # column stream
    (2, 256, 384, None, False),
    (48, 120, 192, None, False),            # tile kernel from here on
    (5, 130, 7, None, False),
    (200, 300, 260, None, True),
]


def _draw(shape, dtype, g, dev):
    if dtype == torch.int8:
        return torch.randint(-8, 9, shape, generator=g, device=dev).to(dtype)
    return torch.randn(shape, generator=g, device=dev).to(dtype)


def tensor_core_atol(k):
    """Up to one ulp (2^-23 relative) of a running sum within 4 sqrt(K) at
    each of K/16 tensor-core accumulation steps; as in chip_smoke.py."""
    return 2.0 ** -23 * (k / 16) * 4 * math.sqrt(k)


def fp8_tensor_core_atol(k):
    """Up to 2^-13 of a running partial within 4 sqrt(128) at each of K/32
    fp8 tensor-core slices, promoted into fp32 every 128 k; as in
    chip_smoke.py."""
    return 2.0 ** -13 * (k / 32) * 4 * math.sqrt(min(k, 128))


def _assert_close(got, want, k, out_dtype=torch.float32, tensor_cores=False,
                  fp8=False):
    ulp = {torch.bfloat16: 2.0 ** -7, torch.float16: 2.0 ** -10}.get(
        out_dtype, 0.0)
    err = (got.float() - want.float()).abs()
    tol = (1e-5 * math.sqrt(k) + (tensor_core_atol(k) if tensor_cores else 0)
           + (fp8_tensor_core_atol(k) if fp8 else 0)
           + (1e-5 + ulp) * want.float().abs())
    assert bool((err <= tol).all()), float(err.max())


@pytest.mark.parametrize("dtype_name", DTYPES)
@pytest.mark.parametrize("geom", GEOMETRIES,
                         ids=[f"{g[0]}x{g[1]}x{g[2]}{'T' if g[4] else ''}"
                              for g in GEOMETRIES])
def test_kernel_matches_plain_version(cuda, dtype_name, geom):
    """The stream kernels where B is vector-loadable and M is small, the
    tile kernel otherwise."""
    m, k, n, block, tb = geom
    dtype = getattr(torch, dtype_name)
    g = torch.Generator(device=cuda).manual_seed(m * n + k)
    a = _draw((m, k), dtype, g, cuda)
    b = _draw((n, k), dtype, g, cuda).T if tb else _draw((k, n), dtype, g, cuda)
    before = mmad_mod.launch_count()
    got = mmad_mod.mmad(a, b, block, torch.float32)
    torch.cuda.synchronize()
    assert mmad_mod.launch_count() == before + 1
    _assert_close(got, ref.mmad_ref(a, b, torch.float32), k)


@pytest.mark.parametrize("dtype_name", DTYPES)
@pytest.mark.parametrize("transposed", [False, True], ids=["rows", "cols"])
def test_stream_kernels_write_c_directly_when_unsplit(cuda, dtype_name,
                                                      transposed):
    """Enough columns fill the card without a K split: the stream kernel
    writes C itself, as the column stream does for gemma-2b's lm_head."""
    dtype = getattr(torch, dtype_name)
    m, k = 4, 512
    # a row-stream tile per SM
    n = mmad_mod._num_sms(cuda) * mmad_mod.ROW_VECS * (16 // dtype.itemsize)
    g = torch.Generator(device=cuda).manual_seed(k + transposed)
    a = _draw((m, k), dtype, g, cuda)
    b = _draw((n, k), dtype, g, cuda).T if transposed else _draw((k, n), dtype,
                                                              g, cuda)
    variant, _, splits = mmad_mod.plan_launch(
        m, n, k, None, mmad_mod._num_sms(cuda), mmad_mod.b_layout(b),
        b.element_size())
    assert splits == 1
    assert variant == (mmad_mod.COL_STREAM if transposed
                       else mmad_mod.ROW_STREAM)
    for out_dtype in (torch.float32, torch.bfloat16):
        got = mmad_mod.mmad(a, b, None, out_dtype)
        _assert_close(got, ref.mmad_ref(a, b, out_dtype), k, out_dtype)


SPLIT_SHAPES = [
    # (m, k, n, transposed B): gemma-2b's q/o, k/v and down, which the row
    # stream splits over K, and the column stream split over few columns
    (4, 2048, 2048, False), (4, 2048, 256, False), (4, 16384, 2048, False),
    (4, 2048, 256, True),
]


@pytest.mark.parametrize("shape", SPLIT_SHAPES,
                         ids=[f"{s[0]}x{s[1]}x{s[2]}{'T' if s[3] else ''}"
                              for s in SPLIT_SHAPES])
def test_split_launches_are_repeatable_and_leave_counters_zero(cuda, shape):
    """The last split to arrive sums the partials in split order, so two
    launches agree bit for bit; it also resets its tile's counter."""
    m, k, n, tb = shape
    g = torch.Generator(device=cuda).manual_seed(k + n)
    a = _draw((m, k), torch.bfloat16, g, cuda)
    b = (_draw((n, k), torch.bfloat16, g, cuda).T if tb
         else _draw((k, n), torch.bfloat16, g, cuda))
    variant, _, splits = mmad_mod.plan_launch(
        m, n, k, None, mmad_mod._num_sms(cuda), mmad_mod.b_layout(b),
        b.element_size())
    assert variant != mmad_mod.TILE and splits > 1
    stream = torch.cuda.current_stream(cuda).cuda_stream
    first = mmad_mod.mmad(a, b, None, torch.float32)
    for _ in range(3):
        again = mmad_mod.mmad(a, b, None, torch.float32)
        torch.cuda.synchronize()
        assert torch.equal(first, again)
        assert int(mmad_mod.counter_buffer(cuda, stream).abs().sum()) == 0
    _assert_close(first, ref.mmad_ref(a, b, torch.float32), k)


@pytest.mark.parametrize("dtype_name", DTYPES)
@pytest.mark.parametrize("transposed", [False, True], ids=["rows", "cols"])
def test_stream_kernels_fix_up_split_k_in_the_launch(cuda, dtype_name,
                                                     transposed):
    """Few columns split K: the stream kernel's last split writes C, one
    kernel launch per call."""
    dtype = getattr(torch, dtype_name)
    m, k, n = 4, 4096, 512
    g = torch.Generator(device=cuda).manual_seed(k + transposed)
    a = _draw((m, k), dtype, g, cuda)
    b = _draw((n, k), dtype, g, cuda).T if transposed else _draw((k, n), dtype,
                                                              g, cuda)
    variant, _, splits = mmad_mod.plan_launch(
        m, n, k, None, mmad_mod._num_sms(cuda), mmad_mod.b_layout(b),
        b.element_size())
    assert splits > 1
    assert variant == (mmad_mod.COL_STREAM if transposed
                       else mmad_mod.ROW_STREAM)
    for out_dtype in (torch.float32, torch.bfloat16):
        got = mmad_mod.mmad(a, b, None, out_dtype)
        _assert_close(got, ref.mmad_ref(a, b, out_dtype), k, out_dtype)


@pytest.mark.parametrize("out_name", ["bfloat16", "float16", "float32"])
def test_kernel_output_dtypes(cuda, out_name):
    out_dtype = getattr(torch, out_name)
    g = torch.Generator(device=cuda).manual_seed(1)
    a = _draw((4, 1024), torch.bfloat16, g, cuda)
    b = _draw((1024, 640), torch.bfloat16, g, cuda)
    got = mmad_mod.mmad(a, b, None, out_dtype=out_dtype)
    assert got.dtype == out_dtype
    _assert_close(got, ref.mmad_ref(a, b, out_dtype), 1024, out_dtype)


def test_mixed_operand_dtypes(cuda):
    """_cast_operand never narrows, so fp32 activations can meet bf16
    weights: the kernel reads each operand at its own dtype."""
    g = torch.Generator(device=cuda).manual_seed(2)
    a = _draw((4, 512), torch.float32, g, cuda)
    b = _draw((512, 256), torch.bfloat16, g, cuda)
    _assert_close(mmad_mod.mmad(a, b, None, torch.float32),
                  ref.mmad_ref(a, b, torch.float32), 512)


def test_local_matmul_runs_the_kernel_with_grads(cuda):
    g = torch.Generator(device=cuda).manual_seed(3)
    a = _draw((8, 256), torch.float32, g, cuda).requires_grad_(True)
    b = _draw((256, 96), torch.float32, g, cuda).requires_grad_(True)
    # no inner kernel: lowering leaves none on a product the stream
    # kernels take, and `mmad` refuses a geometry for one
    before = mmad_mod.launch_count()
    out = ops.local_matmul(a, b, None)
    assert mmad_mod.launch_count() == before + 1
    out.sum().backward()
    ones = torch.ones_like(out)
    _assert_close(a.grad, ones @ b.detach().T, 96)
    _assert_close(b.grad, a.detach().T @ ones, 8)


def test_routed_smoke_decode_launches_one_kernel_per_dispatch(cuda, tmp_path,
                                                              capsys):
    from repro_torch.configs import smoke_config
    from repro_torch.launch import serve
    from repro_torch.models import shard_ctx
    from repro_torch.models.model import init_params
    cfg = smoke_config("gemma-2b")
    params = init_params(torch.Generator(device=cuda).manual_seed(0), cfg,
                         cuda)
    planner = serve.warm_plan_cache(cfg, 2, 4, 8, str(tmp_path), (4, 4), 12)
    ctx = serve.install_gemm_context(planner, cuda)
    try:
        mmad_mod.reset_launch_count()
        prompts = torch.randint(0, cfg.vocab, (2, 4), device=cuda)
        out = serve.generate(params, cfg, prompts, 4)
    finally:
        shard_ctx.set_gemm_context(None)
    assert bool(torch.isfinite(out["logits"]).all())
    assert ctx.stats.resolve_rate == 1.0
    assert mmad_mod.launch_count() == ctx.stats.executed_gemm == 8 * (
        7 * cfg.n_layers + 1)
    capsys.readouterr()


# ---------------------------------------------------------------------------
# the train path
# ---------------------------------------------------------------------------

def _smoke_train_inputs(device, dtype=torch.bfloat16):
    import dataclasses
    from repro_torch.configs import smoke_config
    from repro_torch.data.pipeline import DataConfig, SyntheticLM
    from repro_torch.models.model import init_params, make_trainable
    cfg = dataclasses.replace(smoke_config("gemma-2b"), dtype=dtype)
    params = make_trainable(init_params(torch.Generator().manual_seed(0), cfg,
                                        "cpu")).to(device)
    batch = SyntheticLM(DataConfig(vocab=cfg.vocab, seq_len=32,
                                   global_batch=2)).batch(0)
    return cfg, params, {k: torch.from_numpy(v).to(device, torch.long)
                         for k, v in batch.items()}


def test_tile_kernel_on_embed_T_at_a_loss_chunk(cuda):
    """The train path's lm_head: a loss chunk of M = 1024 rows against the
    tied weight read in place as `embed.T` (256000 x 2048 bf16), on the
    tensor-core tile kernel."""
    g = torch.Generator(device=cuda).manual_seed(4)
    a = _draw((1024, 2048), torch.bfloat16, g, cuda)
    embed = _draw((256000, 2048), torch.bfloat16, g, cuda)
    block = None
    variant, _, _ = mmad_mod.plan_launch(
        1024, 256000, 2048, block, mmad_mod._num_sms(cuda),
        mmad_mod.b_layout(embed.T), 2, mmad_mod.wgmma_b_major(a, embed.T))
    assert variant == mmad_mod.WGMMA
    got = mmad_mod.mmad(a, embed.T, block, torch.float32)
    torch.cuda.synchronize()
    _assert_close(got, ref.mmad_ref(a, embed.T, torch.float32), 2048,
                  tensor_cores=True)


# ---------------------------------------------------------------------------
# the tensor-core variant (wgmma + TMA)
# ---------------------------------------------------------------------------

# (m, k, n, block): gemma-2b's train GEMMs at batch 2 x seq 1024, at the
# route's own tile (the card view's plans name the same one:
# tests/test_torch_inner_kernel.py)
TRAIN_SHAPES = [
    (2048, 2048, 2048, None),                 # q, o
    (2048, 2048, 256, None),                  # k, v
    (2048, 2048, 16384, None),                # gate, up
    (2048, 16384, 2048, None),                # down
    (1024, 2048, 256000, None),               # lm_head chunk
]


def _wgmma_operands(m, k, n, b_major, dtype, g, dev):
    """A (m, k) and B (k, n), B N-contiguous ('n', a (K, N) weight) or
    K-contiguous ('k', a view like `embed.T`); asserts the route."""
    a = _draw((m, k), dtype, g, dev)
    b = (_draw((k, n), dtype, g, dev) if b_major == "n"
         else _draw((n, k), dtype, g, dev).T)
    assert mmad_mod.wgmma_b_major(a, b) == b_major
    return a, b


def _plan(a, b, block, dev):
    m, k = a.shape
    return mmad_mod.plan_launch(m, b.shape[1], k, block,
                                mmad_mod._num_sms(dev), mmad_mod.b_layout(b),
                                b.element_size(),
                                mmad_mod.wgmma_b_major(a, b),
                                mmad_mod.tile_vectors(a, b))


@pytest.mark.parametrize("b_major", ["n", "k"])
@pytest.mark.parametrize("shape", TRAIN_SHAPES,
                         ids=["qo", "kv", "gate_up", "down", "lm_head"])
def test_wgmma_matches_plain_at_the_train_shapes(cuda, shape, b_major):
    """Each train shape, B in both majors, fp32 and bf16 out, launched three
    times: every launch is one tensor-core kernel, agrees with the plain
    version and with the first launch bit for bit (a slot freed too early
    would show as an intermittent difference)."""
    m, k, n, block = shape
    g = torch.Generator(device=cuda).manual_seed(m + k + n)
    a, b = _wgmma_operands(m, k, n, b_major, torch.bfloat16, g, cuda)
    assert _plan(a, b, block, cuda)[0] == mmad_mod.WGMMA
    for out_dtype in (torch.float32, torch.bfloat16):
        want = ref.mmad_ref(a, b, out_dtype)
        before = mmad_mod.launch_count()
        first = mmad_mod.mmad(a, b, block, out_dtype)
        torch.cuda.synchronize()
        _assert_close(first, want, k, out_dtype, tensor_cores=True)
        for _ in range(2):
            assert torch.equal(mmad_mod.mmad(a, b, block, out_dtype), first)
        assert mmad_mod.launch_count() == before + 3


@pytest.mark.parametrize("shape", TRAIN_SHAPES,
                         ids=["qo", "kv", "gate_up", "down", "lm_head"])
def test_backward_products_at_the_train_shapes(cuda, shape):
    """The backward of each train GEMM on the tensor-core kernel:
    da = g @ b.T and db = a.T @ g, the operands views (b.T K-contiguous,
    lm_head's `embed` N-contiguous, a.T M-contiguous), one launch each,
    against the fp32 plain version under `tensor_core_atol` plus one bf16
    ulp (each is rounded once to bf16)."""
    m, k, n, block = shape
    g = torch.Generator(device=cuda).manual_seed(m + 3 * k + n)
    lm_head = n == 256000
    a, b = _wgmma_operands(m, k, n, "k" if lm_head else "n", torch.bfloat16,
                           g, cuda)
    grad = _draw((m, n), torch.bfloat16, g, cuda)
    g32 = grad.float()
    for x, y in ((grad, b.T), (a.T, grad)):
        assert _plan(x, y, block, cuda)[0] == mmad_mod.WGMMA
    assert mmad_mod.wgmma_a_major(a.T) == "m"
    before = mmad_mod.launch_count()
    da, db = ops.backward_products(g32, a, b)
    torch.cuda.synchronize()
    assert mmad_mod.launch_count() == before + 2
    assert da.dtype == db.dtype == torch.bfloat16
    _assert_close(da, ref.mmad_ref(grad, b.T, torch.float32), n,
                  torch.bfloat16, tensor_cores=True)
    del da
    _assert_close(db, ref.mmad_ref(a.T, grad, torch.float32), m,
                  torch.bfloat16, tensor_cores=True)


def test_local_matmul_backward_runs_on_the_tensor_cores(cuda):
    """bf16 operands on the card: the forward and both backward products
    are `mmad` launches (three), and the grads match the fp32 products of
    the same bf16 values; fp32 operands keep the fp32 backward (one
    launch, with no inner kernel: lowering demotes a bf16 one for fp32
    operands)."""
    g = torch.Generator(device=cuda).manual_seed(7)
    kernel = InnerKernel(128, 128, 64, depth=6, dtype="bfloat16")
    a = _draw((256, 512), torch.bfloat16, g, cuda).requires_grad_(True)
    b = _draw((512, 384), torch.bfloat16, g, cuda).requires_grad_(True)
    grad = _draw((256, 384), torch.bfloat16, g, cuda)
    before = mmad_mod.launch_count()
    ops.local_matmul(a, b, kernel).backward(grad.float())
    torch.cuda.synchronize()
    assert mmad_mod.launch_count() == before + 3
    _assert_close(a.grad, grad.float() @ b.detach().float().T, 384,
                  torch.bfloat16, tensor_cores=True)
    _assert_close(b.grad, a.detach().float().T @ grad.float(), 256,
                  torch.bfloat16, tensor_cores=True)
    x = a.detach().float().requires_grad_(True)
    before = mmad_mod.launch_count()
    ops.local_matmul(x, b.detach().float(), None).sum().backward()
    assert mmad_mod.launch_count() == before + 1


@pytest.mark.parametrize("composition", ["merge", "ring"])
def test_flat_attention_takes_bf16_products_on_the_card(cuda, composition):
    """The routed attention's einsums on the card: bf16 q, k, v take
    tensor-core products with fp32 sums and fp32 out (`aten::bmm.dtype`,
    whose backward the port writes), as the reference's DEFAULT-precision
    einsums do on its chip; the CPU keeps the fp32 einsums. Output and the
    grads of q, k and v against the CPU on the same bf16 values: within
    2e-2 (bf16's 2^-8 relative rounding of the output and of the backward's
    cotangent, on unit-normal inputs)."""
    from repro_torch.core import attention, lower
    from repro_torch.launch.mesh import HostMesh
    plan = lower.ExecPlan(
        mode="flat_" + composition, axes={"row": "data", "col": "model"},
        kwargs={"composition": composition, "head_shard": False,
                "kv_chunk": 256}, view=None, requested="flat_attention",
        grid=(1, 1, 1), shape=(0, 0, 0))
    g = torch.Generator().manual_seed(8)
    shapes = {"q": (2, 64, 8, 32), "k": (2, 64, 2, 32), "v": (2, 64, 2, 32)}
    host = {n: torch.randn(sh, generator=g).bfloat16()
            for n, sh in shapes.items()}
    ct = torch.randn(shapes["q"], generator=g)
    out = {}
    for dev in (torch.device("cpu"), cuda):
        x = {n: t.to(dev, copy=True).requires_grad_(True)
             for n, t in host.items()}
        assert attention._tensor_core_einsums(x["q"], x["k"], x["v"]) == (
            dev.type == "cuda")
        y = attention.flat_attention(x["q"], x["k"], x["v"],
                                     HostMesh(device=dev), plan)
        y.float().backward(ct.to(dev))
        out[dev.type] = [y.float().cpu()] + [x[n].grad.float().cpu()
                                             for n in "qkv"]
    for got, want in zip(out["cuda"], out["cpu"]):
        torch.testing.assert_close(got, want, rtol=2e-2, atol=2e-2)


RAGGED = [
    # (m, k, n): no dim a multiple of the 128 x 256 tile or the 64-deep K
    # step; bf16 rows of 8 elements are the narrowest a tensor map takes
    (300, 200, 520), (129, 72, 257 + 7), (48, 120, 192), (17, 8, 8),
    (700, 1000, 1800),
]


@pytest.mark.parametrize("dtype_name", ["bfloat16", "float16"])
@pytest.mark.parametrize("b_major", ["n", "k"])
@pytest.mark.parametrize("shape", RAGGED,
                         ids=["x".join(map(str, s)) for s in RAGGED])
def test_wgmma_ragged_edges(cuda, shape, b_major, dtype_name):
    """Boxes that cross the M, N or K edge are zero-filled and the epilogue
    masks its stores: no padding, in bf16 and fp16, all three outputs."""
    m, k, n = shape
    dtype = getattr(torch, dtype_name)
    if b_major == "n" and n % 8:
        n += 8 - n % 8              # an N-contiguous row must be 16-byte whole
    if b_major == "k" and k % 8:
        k += 8 - k % 8
    g = torch.Generator(device=cuda).manual_seed(m * n + k)
    a, b = _wgmma_operands(m, k, n, b_major, dtype, g, cuda)
    block = (128, 128, 64)
    assert _plan(a, b, block, cuda)[0] == mmad_mod.WGMMA
    for out_dtype in (torch.float32, torch.bfloat16, torch.float16):
        got = mmad_mod.mmad(a, b, block, out_dtype)
        torch.cuda.synchronize()
        _assert_close(got, ref.mmad_ref(a, b, out_dtype), k, out_dtype,
                      tensor_cores=True)


@pytest.mark.parametrize("b_major", ["n", "k"])
@pytest.mark.parametrize("mkn,block", [
    ((2048, 2048, 256), None),                # k, v: 16 tiles
    ((256, 4096, 512), (128, 128, 64)),       # 4 tiles, 64 K steps
    ((200, 3000, 304), (64, 64, 64)),         # ragged
])
def test_wgmma_few_tiles_walk_all_of_k_repeatably(cuda, mkn, block, b_major):
    """Few tiles do not split K: one launch per call, one CTA per tile
    over the whole K range, so launches agree bit for bit."""
    m, k, n = mkn
    g = torch.Generator(device=cuda).manual_seed(k + n)
    a, b = _wgmma_operands(m, k, n, b_major, torch.bfloat16, g, cuda)
    assert _plan(a, b, block, cuda) == (mmad_mod.WGMMA, k, 1)
    first = mmad_mod.mmad(a, b, block, torch.float32)
    for _ in range(5):
        again = mmad_mod.mmad(a, b, block, torch.float32)
        torch.cuda.synchronize()
        assert torch.equal(first, again)
    _assert_close(first, ref.mmad_ref(a, b, torch.float32), k,
                  tensor_cores=True)


@pytest.mark.parametrize("a_dtype,b_dtype", [
    ("float32", "float32"), ("float8_e4m3fn", "float8_e4m3fn"),
    ("int8", "int8"), ("float32", "bfloat16"), ("bfloat16", "float16"),
])
def test_simt_tile_kernel_keeps_what_wgmma_does_not_take(cuda, a_dtype,
                                                         b_dtype):
    """fp32 (IEEE, never TF32), int8 and mixed dtypes stay on the SIMT
    tile kernel at a train shape, fp8 where its tensor-core route refuses
    the operands (an M-contiguous A), and so does a bf16 K of 130 (a row
    of 260 bytes no tensor map describes)."""
    g = torch.Generator(device=cuda).manual_seed(5)
    a = (_draw((512, 256), torch.float8_e4m3fn, g, cuda).T
         if a_dtype == "float8_e4m3fn"
         else _draw((256, 512), getattr(torch, a_dtype), g, cuda))
    b = _draw((512, 384), getattr(torch, b_dtype), g, cuda)
    cases = [(a, b)]
    if a_dtype == "float32" and b_dtype == "float32":
        cases.append((_draw((256, 130), torch.bfloat16, g, cuda),
                      _draw((130, 384), torch.bfloat16, g, cuda)))
    for x, y in cases:
        assert mmad_mod.wgmma_b_major(x, y) is None
        assert _plan(x, y, None, cuda)[0] == mmad_mod.TILE
        got = mmad_mod.mmad(x, y, None, torch.float32)
        torch.cuda.synchronize()
        _assert_close(got, ref.mmad_ref(x, y, torch.float32), x.shape[1])


def test_a_refused_wgmma_launch_raises(cuda, monkeypatch):
    """No fallback: operands the tensor-core kernel refuses (fp32 here,
    sent to it by a forced plan) make the wrapper raise, and nothing is
    counted as launched."""
    g = torch.Generator(device=cuda).manual_seed(6)
    a = _draw((256, 512), torch.float32, g, cuda)
    b = _draw((512, 384), torch.float32, g, cuda)
    monkeypatch.setattr(mmad_mod, "plan_launch",
                        lambda *args, **kw: mmad_mod.Launch(
                            mmad_mod.WGMMA, 512, 1, mmad_mod.WGMMA_INSTANCE))
    before = mmad_mod.launch_count()
    with pytest.raises(RuntimeError, match="mmad launch failed"):
        mmad_mod.mmad(a, b, None, torch.float32)
    assert mmad_mod.launch_count() == before


def _ulp(x, bits):
    """One ulp of each element of x in a float format with `bits`
    significant bits (bf16: 8, fp32: 24)."""
    _, e = np.frexp(np.abs(x).astype(np.float64))
    return np.ldexp(1.0, e - bits)


def assert_first_adam_step(old, new_t, new_j, g_t, g_j, lr, wd, eps,
                           bf16):
    """Parameters (numpy, by name) after Adam's first step in two runs, t
    and a reference j, from the same `old` values; shared with
    tests/test_torch_train.py. There the update is
    lr * u(g) (+ decay) with u(g) = g / (|g| + eps), about lr * sign(g), so
    each package's update hangs on its own grads g_t, g_j (as the optimizer
    saw them: clipped, compressed). Where their signs agree,
    |u(g_t) - u(g_j)| <= eps / (min(|g_t|, |g_j|) + eps): tiny unless a
    grad is near eps = 1e-8. So every element whose grads agree in sign
    must agree with the reference's new value within lr times that bound
    (plus lr * 1e-5 for the update's own fp32 roundings), plus one ulp for
    a bf16 param (named in `bf16`: both packages round nearly equal fp32
    values once) or 2e-6 for an fp32 one (measured 1.1e-7). Elements whose
    grads differ in sign (one zero where compression sent 0 in one package
    only, or a grad near zero that bf16 or summation order flipped) must be
    under 1 % of all, and each must have moved no further than one Adam
    step, lr * (1 + wd * |p|) (plus one ulp for bf16), in both packages. An
    unchanged or sign-flipped update fails this on every element that
    moved by more than that tolerance."""
    n = flipped = 0
    for k in old:
        p0 = old[k]
        ulp = (_ulp(np.maximum(np.abs(new_t[k]), np.abs(new_j[k])), 8)
               if k in bf16 else 0.0)
        apart = np.sign(g_t[k]) != np.sign(g_j[k])
        step_bound = lr * (1 + wd * np.abs(p0)) * (1 + 1e-5) + 1e-7 + ulp
        for new in (new_t[k], new_j[k]):
            assert (np.abs(new - p0)[apart] <= step_bound[apart]).all(), k
        small = np.minimum(np.abs(g_t[k]), np.abs(g_j[k]))
        tol = (lr * (eps / (small + eps) + 1e-5)
               + (ulp if k in bf16 else 2e-6))
        err = np.abs(new_t[k] - new_j[k])
        assert (err <= tol)[~apart].all(), (k, float(err[~apart].max()))
        n += p0.size
        flipped += int(apart.sum())
    assert flipped <= 0.01 * n, (flipped, n)


def test_smoke_train_step_on_the_card_matches_the_cpu(cuda, tmp_path,
                                                      capsys):
    """One routed train step (bf16 smoke config) on the card, with the
    tensor-core kernel forward and backward, against the same step on the
    CPU (the plain versions, fp32 backward): loss and grad norm within 2e-2
    relative, the serve
    tests' bf16 tolerance; parameters as `assert_first_adam_step` holds
    them (the first step is about lr * sign(g): within an ulp where the
    grads agree in sign, at most one step where they do not), which an
    unchanged or sign-flipped update fails."""
    from repro_torch.launch import serve, train
    from repro_torch.models import shard_ctx
    from repro_torch.optim import adamw
    from repro_torch.train.steps import make_train_step
    opt = adamw.AdamWConfig(lr=1e-3, warmup_steps=1, total_steps=4)
    planner = train.warm_train_plans(_smoke_train_inputs("cpu")[0], 2, 32,
                                     str(tmp_path), (4, 4), 12)
    out = {}
    for dev in (torch.device("cpu"), cuda):
        cfg, params, batch = _smoke_train_inputs(dev)
        old = {k: v.detach().float().cpu().numpy()
               for k, v in params.named_parameters()}
        bf16 = {k for k, v in params.named_parameters()
                if v.dtype == torch.bfloat16}
        ctx = serve.install_gemm_context(planner, dev)
        try:
            mmad_mod.reset_launch_count()
            params, state, _, m = make_train_step(cfg, opt)(
                params, adamw.init(params), None, batch)
        finally:
            shard_ctx.set_gemm_context(None)
        assert ctx.stats.resolve_rate == 1.0
        if dev.type == "cuda":
            # forward and remat recompute, plus the backward's two products
            # for each forward dispatch
            assert ctx.stats.executed_gemm == 2 * (7 * cfg.n_layers + 1)
            assert mmad_mod.launch_count() == 2 * ctx.stats.executed_gemm
        out[dev.type] = (m, {k: v.detach().float().cpu().numpy()
                             for k, v in params.named_parameters()},
                         {k: v.cpu().numpy() / (1 - opt.b1)
                          for k, v in state.mu.items()})
    (mc, pc, gc), (mg, pg, gg) = out["cpu"], out["cuda"]
    for key in ("loss", "grad_norm"):
        assert torch.isfinite(mg[key])
        torch.testing.assert_close(mg[key].cpu(), mc[key], rtol=2e-2, atol=0)
    check = dict(old=old, new_j=pc, g_t=gg, g_j=gc, lr=float(mc["lr"]),
                 wd=opt.weight_decay, eps=opt.eps, bf16=bf16)
    assert_first_adam_step(new_t=pg, **check)
    for wrong in (old, {k: 2 * old[k] - pc[k] for k in old}):
        with pytest.raises(AssertionError):
            assert_first_adam_step(new_t=wrong, **check)
    capsys.readouterr()


def test_forward_remat_gives_the_same_grads_on_the_card(cuda, tmp_path,
                                                        capsys):
    """Per-layer remat recomputes each layer with the same kernels on the
    same inputs: at fp32 the grads equal those of the plain forward (rtol
    1e-5, atol 1e-6 leave room only for the order of atomic adds in the
    backward of the embedding gather)."""
    from repro_torch.launch import serve, train
    from repro_torch.models import shard_ctx
    from repro_torch.train.steps import loss_and_grads
    cfg, params, batch = _smoke_train_inputs(cuda, torch.float32)
    planner = train.warm_train_plans(cfg, 2, 32, str(tmp_path), (4, 4), 12)
    ctx = serve.install_gemm_context(planner, cuda)
    try:
        l1, g1 = loss_and_grads(params, batch, cfg, remat=True)
        n_remat = ctx.stats.executed_gemm
        l0, g0 = loss_and_grads(params, batch, cfg, remat=False)
    finally:
        shard_ctx.set_gemm_context(None)
    # remat dispatches each layer's seven GEMMs twice, the plain forward
    # once (the loss chunks are checkpointed either way)
    n_plain = ctx.stats.executed_gemm - n_remat
    assert n_remat == 2 * (7 * cfg.n_layers + 1) == n_plain + 7 * cfg.n_layers
    torch.testing.assert_close(l1, l0, rtol=1e-6, atol=0)
    for k in g0:
        torch.testing.assert_close(g1[k], g0[k], rtol=1e-5, atol=1e-6,
                                   msg=k)
    capsys.readouterr()


# ---------------------------------------------------------------------------
# the model zoo: the MoE router, chunked attention, routed MoE decode
# ---------------------------------------------------------------------------

def test_fp32_router_route_matches_plain(cuda):
    """deepseek-moe-16b's router at decode, fp32 x (4, 2048) @ fp32 router
    (2048, 64): a stream kernel with 4-byte elements, held to the IEEE
    tolerance (no tensor-core term: fp32 never takes the tensor cores),
    and bitwise repeatable."""
    g = torch.Generator(device=cuda).manual_seed(11)
    a = _draw((4, 2048), torch.float32, g, cuda)
    b = _draw((2048, 64), torch.float32, g, cuda)
    block = None
    variant, _, _ = mmad_mod.plan_launch(
        4, 64, 2048, block, torch.cuda.get_device_properties(cuda)
        .multi_processor_count, mmad_mod.b_layout(b), 4,
        mmad_mod.wgmma_b_major(a, b))
    assert variant in (mmad_mod.ROW_STREAM, mmad_mod.COL_STREAM)
    got = mmad_mod.mmad(a, b, block, torch.float32)
    _assert_close(got, ref.mmad_ref(a, b, torch.float32), 2048)
    assert torch.equal(mmad_mod.mmad(a, b, block, torch.float32), got)


def test_chunked_sdpa_matches_plain_on_the_card(cuda):
    """`chunked_sdpa` past 1024 tokens on the card (bf16 q, k, v: 16-bit
    tensor-core products with fp32 sums) against `_sdpa` (fp32 einsums),
    causal, GQA 8 / 2, a ragged length (1100 = 4 x 256 + 76): out and the
    grads of q, k and v within 2e-2 of the largest |value| of `_sdpa`'s
    (bf16 rounding, 2^-8 relative, of p and of the outputs, taken at other
    points)."""
    from repro_torch.models.attention import _sdpa, chunked_sdpa
    g = torch.Generator(device=cuda).manual_seed(12)
    shapes = [(1, 1100, 8, 64), (1, 1100, 2, 64), (1, 1100, 2, 64)]
    xs = [torch.randn(s, generator=g, device=cuda).bfloat16()
          .requires_grad_(True) for s in shapes]
    ct = torch.randn(shapes[0], generator=g, device=cuda).bfloat16()
    res = {}
    for name, fn in (("chunked", chunked_sdpa), ("plain", _sdpa)):
        for x in xs:
            x.grad = None
        out = fn(*xs, causal=True)
        out.backward(ct)
        res[name] = [out.detach()] + [x.grad for x in xs]
    for got, want in zip(res["chunked"], res["plain"]):
        assert got.is_cuda and bool(torch.isfinite(got).all())
        err = (got.float() - want.float()).abs().max() / want.float().abs().max()
        assert float(err) <= 2e-2


def test_routed_smoke_moe_decode_launches_one_kernel_per_dispatch(
        cuda, tmp_path, capsys):
    """deepseek-moe-16b-smoke routed on the card: every routed GEMM (the
    attention projections, the dense MLP, the fp32 router and the shared
    experts) one `mmad` launch; the expert einsums are recorded, not
    dispatched."""
    from repro_torch.configs import smoke_config
    from repro_torch.launch import serve
    from repro_torch.models import shard_ctx
    from repro_torch.models.model import init_params
    cfg = smoke_config("deepseek-moe-16b")
    params = init_params(torch.Generator(device=cuda).manual_seed(0), cfg,
                         cuda)
    planner = serve.warm_plan_cache(cfg, 2, 4, 8, str(tmp_path), (4, 4), 12)
    ctx = serve.install_gemm_context(planner, cuda)
    try:
        mmad_mod.reset_launch_count()
        prompts = torch.randint(0, cfg.vocab, (2, 4), device=cuda)
        out = serve.generate(params, cfg, prompts, 4)
    finally:
        shard_ctx.set_gemm_context(None)
    assert bool(torch.isfinite(out["logits"]).all())
    assert ctx.stats.resolve_rate == 1.0
    moe_layers = cfg.n_layers - cfg.n_dense_layers
    per_step = 4 * cfg.n_layers + 3 * cfg.n_dense_layers + 4 * moe_layers + 1
    assert mmad_mod.launch_count() == ctx.stats.executed_gemm == 8 * per_step
    assert {"moe.expert_gate", "moe.expert_down"} <= {
        tag for tag, _ in ctx.stats.observed}
    capsys.readouterr()


# ---------------------------------------------------------------------------
# deepseek-v2-236b (MLA) and deepseek-moe-16b training
# ---------------------------------------------------------------------------

# (m, k, n, dtype): deepseek-v2-236b's decode GEMMs at batch 4 (the row
# stream kernels; the router fp32), then the naive prefill's at batch 4 x
# prompt 32 (bf16, the tensor-core kernel: `mla.k_rope`'s N = 64 and
# `mla.kv_down`'s N = 512 are narrower than its 256-wide tile)
V2_DECODE = [
    (4, 5120, 1536, "bfloat16"),        # mla.q_down
    (4, 1536, 24576, "bfloat16"),       # mla.q_up
    (4, 5120, 512, "bfloat16"),         # mla.kv_down
    (4, 5120, 64, "bfloat16"),          # mla.k_rope
    (4, 16384, 5120, "bfloat16"),       # mla.o
    (4, 5120, 12288, "bfloat16"),       # dense mlp gate, up
    (4, 12288, 5120, "bfloat16"),       # dense mlp down
    (4, 5120, 160, "float32"),          # moe.router
    (4, 5120, 3072, "bfloat16"),        # shared experts gate, up
    (4, 3072, 5120, "bfloat16"),        # shared experts down
    (4, 5120, 102400, "bfloat16"),      # lm_head
]
V2_PREFILL = [
    (128, 5120, 64), (128, 5120, 512), (128, 512, 16384), (128, 1536, 24576),
    (128, 16384, 5120),
]


@pytest.mark.parametrize("shape", V2_DECODE,
                         ids=[f"{m}x{k}x{n}-{d}" for m, k, n, d in V2_DECODE])
def test_kernel_at_the_deepseek_v2_decode_shapes(cuda, shape):
    """Each decode GEMM of deepseek-v2-236b on a stream kernel (the fp32
    router too), against the plain version at the IEEE tolerance and
    bitwise repeatable."""
    m, k, n, dtype_name = shape
    dtype = getattr(torch, dtype_name)
    g = torch.Generator(device=cuda).manual_seed(m + k + n)
    a, b = _draw((m, k), dtype, g, cuda), _draw((k, n), dtype, g, cuda)
    block = None
    assert _plan(a, b, block, cuda)[0] == mmad_mod.ROW_STREAM
    got = mmad_mod.mmad(a, b, block, torch.float32)
    torch.cuda.synchronize()
    _assert_close(got, ref.mmad_ref(a, b, torch.float32), k)
    assert torch.equal(mmad_mod.mmad(a, b, block, torch.float32), got)


@pytest.mark.parametrize("mkn", V2_PREFILL,
                         ids=["x".join(map(str, s)) for s in V2_PREFILL])
def test_wgmma_at_the_deepseek_v2_prefill_shapes(cuda, mkn):
    """MLA's naive prefill GEMMs (M = 128) on the tensor-core kernel, N as
    narrow as 64, in fp32 and bf16 out."""
    m, k, n = mkn
    g = torch.Generator(device=cuda).manual_seed(k + n)
    a, b = _wgmma_operands(m, k, n, "n", torch.bfloat16, g, cuda)
    block = None
    assert _plan(a, b, block, cuda)[0] == mmad_mod.WGMMA
    for out_dtype in (torch.float32, torch.bfloat16):
        got = mmad_mod.mmad(a, b, block, out_dtype)
        torch.cuda.synchronize()
        _assert_close(got, ref.mmad_ref(a, b, out_dtype), k, out_dtype,
                      tensor_cores=True)


def test_fp32_router_at_the_moe_train_shape_takes_the_simt_tile_kernel(cuda):
    """deepseek-moe-16b's router in training, fp32 x (2048, 2048) @ fp32
    router (2048, 64): the SIMT tile kernel's 64-wide narrow instance
    (fp32 never takes the tensor cores, nor TF32), K split and fixed up by
    the last split in the same launch, held to the IEEE tolerance and
    bitwise repeatable; its backward is two fp32 `torch.matmul` products,
    not `mmad`."""
    g = torch.Generator(device=cuda).manual_seed(13)
    a = _draw((2048, 2048), torch.float32, g, cuda)
    b = _draw((2048, 64), torch.float32, g, cuda)
    block = None
    variant, _, splits = _plan(a, b, block, cuda)
    assert variant == mmad_mod.TILE and splits > 1
    got = mmad_mod.mmad(a, b, block, torch.float32)
    torch.cuda.synchronize()
    _assert_close(got, ref.mmad_ref(a, b, torch.float32), 2048)
    assert torch.equal(mmad_mod.mmad(a, b, block, torch.float32), got)
    assert not ops.tensor_core_backward(a, b)


def test_mla_absorbed_decode_on_the_card_matches_the_cpu(cuda, tmp_path,
                                                         capsys):
    """deepseek-v2-236b-smoke's MLA block (q_lora on) decoding 8 tokens
    routed on the card (the absorbed form: the projections on `mmad`, the
    MQA over the latent cache at hkv = 1 and dv = r != d) against the same
    calls on CPU tensors (the kernels' plain versions), fp32 weights: the
    outputs and the cache within 1e-4 of the CPU's largest value."""
    import dataclasses
    from repro_torch.configs import smoke_config
    from repro_torch.deploy.warmup import build_planner
    from repro_torch.launch import mesh
    from repro_torch.models import attention, shard_ctx
    cfg = dataclasses.replace(smoke_config("deepseek-v2-236b"),
                              dtype=torch.float32)
    cpu = torch.device("cpu")
    p = attention.mla_params(torch.Generator().manual_seed(0), cfg, cpu)
    x = torch.randn((2, 8, cfg.d_model), generator=torch.Generator()
                    .manual_seed(1))
    planner = build_planner(str(tmp_path), (4, 4), 12)
    outs, caches = {}, {}
    for dev in (cpu, cuda):
        layer = attention.MLA(None, cfg, "meta")
        layer.load_state_dict({k: v.to(dev) for k, v in
                               p.state_dict().items()}, assign=True)
        cache = attention.make_kv_cache(cfg, 2, 8, dev)
        shard_ctx.set_gemm_context(shard_ctx.GemmContext(
            mesh=mesh.make_host_mesh(dev), planner=planner))
        try:
            steps = []
            with torch.inference_mode():
                for i in range(8):
                    y, cache = attention.mla_attention(
                        layer, x[:, i:i + 1].to(dev), cfg,
                        torch.arange(i, i + 1, device=dev), cache)
                    steps.append(y.cpu())
        finally:
            shard_ctx.set_gemm_context(None)
        outs[dev.type], caches[dev.type] = torch.cat(steps, 1), cache
    scale = float(outs["cpu"].abs().max())
    assert float((outs["cuda"] - outs["cpu"]).abs().max()) <= 1e-4 * scale
    for key in ("c_kv", "k_rope"):
        torch.testing.assert_close(caches["cuda"][key].cpu(),
                                   caches["cpu"][key], rtol=1e-4, atol=1e-5)
    assert caches["cuda"]["index"] == 8
    capsys.readouterr()


# ---------------------------------------------------------------------------
# zamba2-1.2b and xlstm-1.3b (the recurrent stacks)
# ---------------------------------------------------------------------------

# (m, k, n, dtype): the recurrent stacks' decode GEMMs at batch 4, all on
# the row stream; xlstm's fp32 gates are 32 bytes a row (N = 8)
SSM_DECODE = [
    (4, 2048, 8384, "bfloat16"),        # mamba.in
    (4, 4096, 2048, "bfloat16"),        # mamba.out, mlstm.down
    (4, 2048, 8192, "bfloat16"),        # mlstm.up, slstm.in, zamba2 mlp
    (4, 4096, 4096, "bfloat16"),        # mlstm.q, k, v
    (4, 2048, 8, "float32"),            # mlstm.gates
]


@pytest.mark.parametrize("shape", SSM_DECODE,
                         ids=[f"{m}x{k}x{n}-{d}" for m, k, n, d in SSM_DECODE])
def test_kernel_at_the_ssm_decode_shapes(cuda, shape):
    """Each decode GEMM of zamba2-1.2b and xlstm-1.3b on the row stream,
    the fp32 gates at N = 8 too, against the plain version at the IEEE
    tolerance and bitwise repeatable."""
    m, k, n, dtype_name = shape
    dtype = getattr(torch, dtype_name)
    g = torch.Generator(device=cuda).manual_seed(m + k + n)
    a, b = _draw((m, k), dtype, g, cuda), _draw((k, n), dtype, g, cuda)
    block = None
    assert _plan(a, b, block, cuda)[0] == mmad_mod.ROW_STREAM
    got = mmad_mod.mmad(a, b, block, torch.float32)
    torch.cuda.synchronize()
    _assert_close(got, ref.mmad_ref(a, b, torch.float32), k)
    assert torch.equal(mmad_mod.mmad(a, b, block, torch.float32), got)


def test_fp32_gates_at_the_forward_shape_take_the_simt_tile_kernel(cuda):
    """xlstm's gates in a forward of 512 tokens, fp32 x (512, 2048) @ fp32
    w_gates (2048, 8): the SIMT tile kernel's 8-wide narrow instance, held
    to the IEEE tolerance and bitwise repeatable."""
    g = torch.Generator(device=cuda).manual_seed(14)
    a = _draw((512, 2048), torch.float32, g, cuda)
    b = _draw((2048, 8), torch.float32, g, cuda)
    block = None
    assert _plan(a, b, block, cuda)[0] == mmad_mod.TILE
    got = mmad_mod.mmad(a, b, block, torch.float32)
    torch.cuda.synchronize()
    _assert_close(got, ref.mmad_ref(a, b, torch.float32), 2048)
    assert torch.equal(mmad_mod.mmad(a, b, block, torch.float32), got)


# ---------------------------------------------------------------------------
# the SIMT tile route: its narrow, wide and generic instances
# ---------------------------------------------------------------------------

def _tile_operands(case, g, dev):
    """(a, b) for a TILE_CASES row: `view` cuts A to its first k columns
    and B to its first n of rows whose width is a multiple of 16 elements
    (so rows stay 16-byte aligned while the last 16-byte chunk before an
    edge is cut), or reads B through `embed.T` or A through `a.T`
    (strides no vector instance takes)."""
    _, m, k, n, a_name, b_name, view, _ = case
    a_dt, b_dt = getattr(torch, a_name), getattr(torch, b_name)
    if view == "slice":
        a = _draw((m, -(-(k + 1) // 16) * 16), a_dt, g, dev)[:, :k]
        b = _draw((k, -(-(n + 1) // 16) * 16), b_dt, g, dev)[:, :n]
    elif view == "embed.T":
        a, b = _draw((m, k), a_dt, g, dev), _draw((n, k), b_dt, g, dev).T
    elif view == "a.T":
        a, b = _draw((k, m), a_dt, g, dev).T, _draw((k, n), b_dt, g, dev)
    else:
        a, b = _draw((m, k), a_dt, g, dev), _draw((k, n), b_dt, g, dev)
    return a, b


TILE_CASES = [
    # (name, m, k, n, a dtype, b dtype, view, instance)
    ("router", 2048, 2048, 64, "float32", "float32", None, "narrow64"),
    ("gates", 2048, 2048, 8, "float32", "float32", None, "narrow8"),
    ("gates forward", 512, 2048, 8, "float32", "float32", None, "narrow8"),
    ("narrow64 unsplit", 16896, 256, 64, "float32", "float32", None,
     "narrow64"),
    ("narrow8 unsplit", 16896, 512, 8, "float32", "float32", None,
     "narrow8"),
    ("fp8 narrow", 16, 512, 8, "float8_e4m3fn", "float8_e4m3fn", "slice",
     "narrow16"),
    ("int8 narrow", 300, 1024, 32, "int8", "int8", None, "narrow32"),
    ("fp32 ragged N", 333, 1000, 20, "float32", "float32", None,
     "narrow32"),
    ("fp32 ragged chunks", 130, 1030, 18, "float32", "float32", "slice",
     "narrow32"),
    ("wide fp32", 2048, 2048, 2048, "float32", "float32", None, "wide"),
    ("wide fp8", 16, 2048, 2040, "float8_e4m3fn", "float8_e4m3fn", "slice",
     "wide"),
    ("wide int8 ragged", 200, 336, 272, "int8", "int8", None, "wide"),
    ("wide fp32 ragged", 777, 520, 1000, "float32", "float32", "slice",
     "wide"),
    ("bf16 K = 130", 256, 130, 384, "bfloat16", "bfloat16", None, "generic"),
    ("bf16 K = 130 unsplit", 4096, 130, 4096, "bfloat16", "bfloat16", None,
     "generic"),
    ("mixed fp32 x bf16", 256, 512, 384, "float32", "bfloat16", None,
     "generic"),
    ("mixed fp8 x int8", 100, 300, 40, "float8_e4m3fn", "int8", None,
     "generic"),
    ("fp32 embed.T", 200, 300, 260, "float32", "float32", "embed.T",
     "generic"),
    ("fp32 a.T", 512, 256, 384, "float32", "float32", "a.T", "generic"),
]


@pytest.mark.parametrize("out_name", ["float32", "bfloat16", "float16"])
@pytest.mark.parametrize("case", TILE_CASES, ids=[c[0] for c in TILE_CASES])
def test_simt_tile_route_matches_plain(cuda, case, out_name):
    """Each instance of the SIMT tile route — narrow (N up to 64: the train
    router's 64 and the gates' 8), wide, and generic (mixed dtypes, K =
    130 bf16, `embed.T`, `a.T`) — at ragged M, N and K edges, split and
    unsplit, against the plain version in each out dtype: one launch, the
    IEEE tolerance, a second launch bitwise equal, and the split counters
    left at zero."""
    out_dtype = getattr(torch, out_name)
    g = torch.Generator(device=cuda).manual_seed(sum(case[1:4]))
    a, b = _tile_operands(case, g, cuda)
    m, k = a.shape
    n = b.shape[1]
    assert _plan(a, b, None, cuda)[0] == mmad_mod.TILE
    geo = mmad_mod.tile_geometry(m, n, k, a.element_size(), b.element_size(),
                                 mmad_mod._num_sms(cuda),
                                 mmad_mod.tile_vectors(a, b))
    assert geo.instance == case[7]
    if "unsplit" in case[0]:
        assert geo.splits == 1
    elif case[0] in ("router", "gates", "bf16 K = 130"):
        assert geo.splits > 1
    before = mmad_mod.launch_count()
    got = mmad_mod.mmad(a, b, None, out_dtype)
    torch.cuda.synchronize()
    assert mmad_mod.launch_count() == before + 1
    _assert_close(got, ref.mmad_ref(a, b, out_dtype), k, out_dtype)
    assert torch.equal(mmad_mod.mmad(a, b, None, out_dtype), got)
    torch.cuda.synchronize()
    assert all(int(c.abs().sum()) == 0 for c in mmad_mod._counters.values())


def test_simt_tile_route_is_one_kernel_a_call(cuda):
    """A split call of the SIMT tile route (the train router) runs exactly
    one `mmad` kernel, `mmad_tile_kernel`, and no split-K reduce kernel:
    the last split to arrive fixes the tile up in the same launch."""
    g = torch.Generator(device=cuda).manual_seed(15)
    a = _draw((2048, 2048), torch.float32, g, cuda)
    b = _draw((2048, 64), torch.float32, g, cuda)
    assert _plan(a, b, None, cuda)[2] > 1
    mmad_mod.mmad(a, b, None, torch.float32)
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        mmad_mod.mmad(a, b, None, torch.float32)
        torch.cuda.synchronize()
    names = [e.name for e in prof.events()
             if e.device_type == torch.autograd.DeviceType.CUDA
             and "mmad" in e.name]
    assert len(names) == 1 and "mmad_tile_kernel" in names[0], names
    assert not any("splitk" in name for name in names)


def test_a_refused_tile_launch_raises(cuda, monkeypatch):
    """No fallback: operands a vector instance cannot read (fp32 rows of
    130 elements, 520 bytes, sent to one by a forced predicate) make the
    launcher refuse and the wrapper raise, and nothing is counted."""
    g = torch.Generator(device=cuda).manual_seed(16)
    a = _draw((256, 130), torch.float32, g, cuda)
    b = _draw((130, 64), torch.float32, g, cuda)
    monkeypatch.setattr(mmad_mod, "tile_vectors", lambda *_: True)
    before = mmad_mod.launch_count()
    with pytest.raises(RuntimeError, match="mmad launch failed"):
        mmad_mod.mmad(a, b, None, torch.float32)
    assert mmad_mod.launch_count() == before


def test_wgmma_at_the_ragged_mamba_in_forward_shape(cuda):
    """zamba2's fused in-projection in a forward of 512 tokens, bf16 (512,
    2048) @ (2048, 8384): the tensor-core kernel, N not a multiple of its
    256-wide tile (the last tile 192 wide, zero-filled by TMA), in fp32 and
    bf16 out."""
    g = torch.Generator(device=cuda).manual_seed(15)
    a, b = _wgmma_operands(512, 2048, 8384, "n", torch.bfloat16, g, cuda)
    block = None
    assert _plan(a, b, block, cuda)[0] == mmad_mod.WGMMA
    for out_dtype in (torch.float32, torch.bfloat16):
        got = mmad_mod.mmad(a, b, block, out_dtype)
        torch.cuda.synchronize()
        _assert_close(got, ref.mmad_ref(a, b, out_dtype), 2048, out_dtype,
                      tensor_cores=True)


@pytest.mark.parametrize("arch", ["zamba2-1.2b", "xlstm-1.3b"])
def test_routed_smoke_ssm_decode_on_the_card_matches_the_cpu(cuda, arch,
                                                             tmp_path,
                                                             capsys):
    """The smoke model of each recurrent stack at fp32 decoding 8 tokens
    routed on the card (the projections on `mmad`, the recurrent steps on
    fp32 state in place) against the same weights and calls on CPU tensors
    (the kernels' plain versions): logits within 1e-4 of the CPU's largest
    value, one `mmad` launch per routed dispatch."""
    import dataclasses
    from repro_torch.configs import smoke_config
    from repro_torch.deploy.warmup import build_planner
    from repro_torch.launch import mesh
    from repro_torch.models import shard_ctx
    from repro_torch.models.model import (decode_init, decode_step,
                                          init_params)
    cfg = dataclasses.replace(smoke_config(arch), dtype=torch.float32)
    cpu = torch.device("cpu")
    params = init_params(torch.Generator().manual_seed(0), cfg, cpu)
    prompts = torch.randint(0, cfg.vocab, (2, 8),
                            generator=torch.Generator().manual_seed(1))
    planner = build_planner(str(tmp_path), (4, 4), 12)
    logits = {}
    for dev in (cpu, cuda):
        model = init_params(None, cfg, "meta")
        model.load_state_dict({k: v.to(dev) for k, v in
                               params.state_dict().items()}, assign=True)
        ctx = shard_ctx.GemmContext(mesh=mesh.make_host_mesh(dev),
                                    planner=planner)
        shard_ctx.set_gemm_context(ctx)
        mmad_mod.reset_launch_count()
        try:
            steps = []
            with torch.inference_mode():
                caches = decode_init(model, cfg, 2, 8)
                for i in range(8):
                    out, caches = decode_step(model, caches,
                                              prompts[:, i:i + 1].to(dev), i,
                                              cfg)
                    steps.append(out.cpu())
        finally:
            shard_ctx.set_gemm_context(None)
        logits[dev.type] = torch.stack(steps)
        if dev.type == "cuda":
            assert mmad_mod.launch_count() == ctx.stats.executed_gemm > 0
    scale = float(logits["cpu"].abs().max())
    assert float((logits["cuda"] - logits["cpu"]).abs().max()) <= 1e-4 * scale
    capsys.readouterr()


# ---------------------------------------------------------------------------
# seamless-m4t-medium and phi-3-vision-4.2b (the frontend models)
# ---------------------------------------------------------------------------

# (m, k, n, B major, variant): the frontend models' new GEMM shapes.
# seamless decodes its cross-attention K and V at the encoder's 4 x 960
# rows; its tied lm_head's N = 256,206 is not a multiple of 8, so `embed.T`
# streams by columns at decode and leaves a 206-wide last tile in a
# forward; phi-3-vision's prefix forward runs 4 x (576 + 32) rows, its
# lm_head's last tile 64 wide, and `frontend.proj` at 4 x 576.
FRONTEND_SHAPES = [
    (3840, 1024, 1024, "n", mmad_mod.WGMMA),        # cross K / V
    (4, 1024, 256206, "k", mmad_mod.COL_STREAM),    # seamless lm_head
    (128, 1024, 256206, "k", mmad_mod.WGMMA),       # its prefill lm_head
    (2432, 3072, 32064, "k", mmad_mod.WGMMA),       # phi-3-vision lm_head
    (2304, 3072, 3072, "n", mmad_mod.WGMMA),        # frontend.proj
]


@pytest.mark.parametrize("shape", FRONTEND_SHAPES,
                         ids=[f"{m}x{k}x{n}" for m, k, n, _, _ in
                              FRONTEND_SHAPES])
def test_kernel_at_the_frontend_model_shapes(cuda, shape):
    """Each new shape on the variant its operands take (a (K, N) weight,
    or the tied lm_head's `embed.T` view), against the plain version, fp32
    and bf16 out, and bitwise repeatable."""
    m, k, n, b_major, variant = shape
    g = torch.Generator(device=cuda).manual_seed(m + k + n)
    a = _draw((m, k), torch.bfloat16, g, cuda)
    b = (_draw((k, n), torch.bfloat16, g, cuda) if b_major == "n"
         else _draw((n, k), torch.bfloat16, g, cuda).T)
    block = None
    assert _plan(a, b, block, cuda)[0] == variant
    tensor_cores = variant == mmad_mod.WGMMA
    for out_dtype in (torch.float32, torch.bfloat16):
        got = mmad_mod.mmad(a, b, block, out_dtype)
        torch.cuda.synchronize()
        _assert_close(got, ref.mmad_ref(a, b, out_dtype), k, out_dtype,
                      tensor_cores)
        assert torch.equal(mmad_mod.mmad(a, b, block, out_dtype), got)


@pytest.mark.parametrize("arch", ["seamless-m4t-medium", "phi-3-vision-4.2b"])
def test_routed_smoke_frontend_models_on_the_card_match_the_cpu(cuda, arch,
                                                                tmp_path,
                                                                capsys):
    """The smoke model at fp32, routed on the card against the same
    weights and calls on CPU tensors (the kernels' plain versions): the
    forward with its frontend input (seamless's frames, phi-3-vision's
    patch embeddings) and 8 decode steps (seamless's attending to an
    encoder output), logits within 1e-4 of the CPU's largest value, one
    `mmad` launch per routed dispatch."""
    import dataclasses
    from repro_torch.configs import smoke_config
    from repro_torch.deploy.warmup import build_planner
    from repro_torch.launch import mesh
    from repro_torch.models import shard_ctx
    from repro_torch.models.model import (decode_init, decode_step, forward,
                                          init_params)
    cfg = dataclasses.replace(smoke_config(arch), dtype=torch.float32)
    cpu = torch.device("cpu")
    params = init_params(torch.Generator().manual_seed(0), cfg, cpu)
    g = torch.Generator().manual_seed(1)
    prompts = torch.randint(0, cfg.vocab, (2, 8), generator=g)
    extra = torch.randn((2, cfg.n_prefix, cfg.d_model), generator=g)
    key = "encoder_embeds" if cfg.is_encoder_decoder else "prefix_embeds"
    planner = build_planner(str(tmp_path), (4, 4), 12)
    out = {}
    for dev in (cpu, cuda):
        model = init_params(None, cfg, "meta")
        model.load_state_dict({k: v.to(dev) for k, v in
                               params.state_dict().items()}, assign=True)
        ctx = shard_ctx.GemmContext(mesh=mesh.make_host_mesh(dev),
                                    planner=planner)
        shard_ctx.set_gemm_context(ctx)
        mmad_mod.reset_launch_count()
        try:
            with torch.inference_mode():
                logits = [forward(model, prompts.to(dev), cfg,
                                  **{key: extra.to(dev)}).cpu()]
                enc = (extra.to(dev) @ model.frontend_proj
                       if cfg.is_encoder_decoder else None)
                caches = decode_init(model, cfg, 2, 8)
                for i in range(8):
                    step, caches = decode_step(model, caches,
                                               prompts[:, i:i + 1].to(dev),
                                               i, cfg, encoder_out=enc)
                    logits.append(step.cpu())
        finally:
            shard_ctx.set_gemm_context(None)
        out[dev.type] = logits
        if dev.type == "cuda":
            assert mmad_mod.launch_count() == ctx.stats.executed_gemm > 0
    for got, want in zip(out["cuda"], out["cpu"]):
        scale = float(want.abs().max())
        assert float((got - want).abs().max()) <= 1e-4 * scale
    capsys.readouterr()


# ---------------------------------------------------------------------------
# training the other families: the new backward shapes, the recurrent
# stacks' train step
# ---------------------------------------------------------------------------

# (m, k, n, B major): backward shapes the other families' train steps add.
# zamba2's fused in-projection (N = 8,384: da's K is not a multiple of the
# kernel's K step, so TMA zero-fills the ragged K tail); seamless's tied
# lm_head per loss chunk (N = 256,206: g's bf16 rows are not whole 16
# bytes, so `backward_products` pads them); phi-3-vision's (N = 32,064).
NEW_TRAIN_BACKWARD = [
    (2048, 2048, 8384, "n"),
    (1024, 1024, 256206, "k"),
    (1024, 3072, 32064, "k"),
]


@pytest.mark.parametrize("shape", NEW_TRAIN_BACKWARD,
                         ids=["mamba_in", "seamless_lm_head",
                              "phi3_lm_head"])
def test_backward_products_at_the_other_families_train_shapes(cuda, shape,
                                                              monkeypatch):
    """Both backward products on the tensor-core kernel, one launch each,
    against the fp32 plain version under `tensor_core_atol` plus one bf16
    ulp."""
    m, k, n, b_major = shape
    g = torch.Generator(device=cuda).manual_seed(m + k + n)
    a, b = _wgmma_operands(m, k, n, b_major, torch.bfloat16, g, cuda)
    grad = _draw((m, n), torch.bfloat16, g, cuda)
    routes = []
    real = ops.mmad

    def recorder(x, y, *args, **kw):
        routes.append(_plan(x, y, None, cuda)[0])
        return real(x, y, *args, **kw)

    monkeypatch.setattr(ops, "mmad", recorder)
    before = mmad_mod.launch_count()
    da, db = ops.backward_products(grad.float(), a, b)
    torch.cuda.synchronize()
    assert routes == [mmad_mod.WGMMA, mmad_mod.WGMMA]
    assert mmad_mod.launch_count() == before + 2
    _assert_close(da, ref.mmad_ref(grad, b.T, torch.float32), n,
                  torch.bfloat16, tensor_cores=True)
    del da
    _assert_close(db, ref.mmad_ref(a.T, grad, torch.float32), m,
                  torch.bfloat16, tensor_cores=True)


@pytest.mark.parametrize("arch", ["zamba2-1.2b", "xlstm-1.3b"])
def test_smoke_ssm_train_step_on_the_card_has_finite_grads(cuda, arch,
                                                           tmp_path, capsys):
    """One routed bf16 train step of the recurrent smoke model at seq 256
    (two SSD / mLSTM chunks) on the card, against the same step on CPU
    tensors: every gradient finite on both, the loss and grad norm within
    2e-2 relative (the bf16 tolerance of the smoke train step above), one
    `mmad` launch per routed dispatch plus two per bf16 backward call."""
    from repro_torch.configs import smoke_config
    from repro_torch.data.pipeline import DataConfig, SyntheticLM
    from repro_torch.launch import serve, train
    from repro_torch.models import shard_ctx
    from repro_torch.models.model import init_params, make_trainable
    from repro_torch.optim import adamw
    from repro_torch.train.steps import loss_and_grads
    cfg = smoke_config(arch)
    data = SyntheticLM(DataConfig(vocab=cfg.vocab, seq_len=256,
                                  global_batch=2)).batch(0)
    planner = train.warm_train_plans(cfg, 2, 256, str(tmp_path), (4, 4), 12)
    out = {}
    for dev in (torch.device("cpu"), cuda):
        params = make_trainable(init_params(
            torch.Generator().manual_seed(0), cfg, "cpu")).to(dev)
        batch = {k: torch.from_numpy(v).to(dev, torch.long)
                 for k, v in data.items()}
        ctx = serve.install_gemm_context(planner, dev)
        mmad_mod.reset_launch_count()
        try:
            loss, grads = loss_and_grads(params, batch, cfg)
        finally:
            shard_ctx.set_gemm_context(None)
        assert ctx.stats.resolve_rate == 1.0
        bad = [k for k, v in grads.items() if not torch.isfinite(v).all()]
        assert not bad, bad
        if dev.type == "cuda":
            n_fp32 = 0
            if arch == "xlstm-1.3b":       # the gates: forward + recompute
                n_fp32 = 2 * (cfg.n_layers - cfg.n_layers // cfg.slstm_every)
            executed = ctx.stats.executed_gemm
            assert mmad_mod.launch_count() == executed + (executed - n_fp32)
        out[dev.type] = (float(loss), float(adamw.global_norm(grads)))
    for got, want in zip(out["cuda"], out["cpu"]):
        assert abs(got - want) <= 2e-2 * abs(want)
    capsys.readouterr()


# ---------------------------------------------------------------------------
# fp8 e4m3 on the tensor cores (kernels/mmad.py:fp8_geometry)
# ---------------------------------------------------------------------------

FP8_CASES = [
    # (name, m, k, n, B major, split): a paper shape both ways, ragged M,
    # N and K, one row past the stream kernels, N = 8, rows padded to whole
    # 16 bytes where K or N is not
    ("paper unsplit", 4096, 7168, 2112, "n", False),
    ("paper unsplit w.T", 4096, 7168, 2112, "k", False),
    ("paper flat", 64, 7168, 2112, "n", True),
    ("paper flat w.T", 64, 7168, 2112, "k", True),
    ("ragged", 200, 1040, 300, "n", True),
    ("ragged w.T", 200, 1040, 300, "k", True),
    ("M = 17, N = 8", 17, 512, 8, "n", True),
    ("M = 17, N = 8, w.T", 17, 512, 8, "k", True),
    ("K = 1000", 300, 1000, 260, "n", True),
    ("K = 1000, w.T", 300, 1000, 260, "k", True),
    ("16-deep last step", 2048, 2064, 2048, "k", False),
]


def _fp8_operands(m, k, n, major, g, dev):
    """e4m3 A (m, k) and B (k, n), N-major or the `.T` of an (n, k) one,
    rows padded to whole 16 bytes where k or n is not."""
    def padded(rows, cols):
        return _draw((rows, -(-cols // 16) * 16), torch.float8_e4m3fn, g,
                     dev)[:, :cols]
    return padded(m, k), (padded(k, n) if major == "n" else padded(n, k).T)


@pytest.mark.parametrize("out_name", ["float32", "bfloat16", "float16"])
@pytest.mark.parametrize("case", FP8_CASES, ids=[c[0] for c in FP8_CASES])
def test_fp8_route_matches_plain(cuda, case, out_name):
    """The fp8 tensor-core route split and unsplit, in both B majors and
    each out dtype: one launch a call (an N-major B's transpose is part
    of it), the plain version within the IEEE terms plus
    `fp8_tensor_core_atol`, a second launch bitwise equal, the split
    counters left at zero."""
    name, m, k, n, major, split = case
    out_dtype = getattr(torch, out_name)
    g = torch.Generator(device=cuda).manual_seed(m + k + n)
    a, b = _fp8_operands(m, k, n, major, g, cuda)
    variant, _, splits = _plan(a, b, None, cuda)
    assert variant == mmad_mod.WGMMA_FP8
    assert mmad_mod.wgmma_b_major(a, b) == major
    assert (splits > 1) is split
    before = mmad_mod.launch_count()
    got = mmad_mod.mmad(a, b, None, out_dtype)
    torch.cuda.synchronize()
    assert mmad_mod.launch_count() == before + 1
    _assert_close(got, ref.mmad_ref(a, b, out_dtype), k, out_dtype, fp8=True)
    assert torch.equal(mmad_mod.mmad(a, b, None, out_dtype), got)
    torch.cuda.synchronize()
    assert all(int(c.abs().sum()) == 0 for c in mmad_mod._counters.values())


def _refused_a_t(g, dev):
    return (_draw((512, 256), torch.float8_e4m3fn, g, dev).T,
            _draw((512, 384), torch.float8_e4m3fn, g, dev))


def _refused_int8_b(g, dev):
    return (_draw((256, 512), torch.float8_e4m3fn, g, dev),
            _draw((512, 384), torch.int8, g, dev))


def _refused_k_rows(g, dev):
    return (_draw((256, 100), torch.float8_e4m3fn, g, dev),
            _draw((100, 384), torch.float8_e4m3fn, g, dev))


@pytest.mark.parametrize("operands", [_refused_a_t, _refused_int8_b,
                                      _refused_k_rows],
                         ids=["A M-contiguous", "int8 B", "100-byte A rows"])
def test_a_refused_fp8_launch_raises(cuda, monkeypatch, operands):
    """No fallback: operands the fp8 kernel refuses, sent to it by a forced
    route, make the wrapper raise, and nothing is counted as launched."""
    g = torch.Generator(device=cuda).manual_seed(7)
    a, b = operands(g, cuda)
    monkeypatch.setattr(mmad_mod, "wgmma_b_major", lambda a, b: "n")
    monkeypatch.setattr(mmad_mod, "plan_launch",
                        lambda *args, **kw: mmad_mod.Launch(
                            mmad_mod.WGMMA_FP8, a.shape[1], 1,
                            mmad_mod.fp8_instance(mmad_mod.FP8_BN_FLAT)))
    before = mmad_mod.launch_count()
    with pytest.raises(RuntimeError, match="mmad launch failed"):
        mmad_mod.mmad(a, b, None, torch.float32)
    torch.cuda.synchronize()
    assert mmad_mod.launch_count() == before


@pytest.mark.parametrize("major", ["n", "k"])
def test_fp8_call_kernels(cuda, major):
    """A call with an N-major B runs the transpose, then the fp8 kernel; a
    K-major B the fp8 kernel alone; neither a split-K reduce kernel."""
    g = torch.Generator(device=cuda).manual_seed(8)
    a, b = _fp8_operands(64, 7168, 2112, major, g, cuda)
    mmad_mod.mmad(a, b, None, torch.float32)
    torch.cuda.synchronize()
    # a profile can lose a window's first and last kernels: the call sits
    # between a host pause and spin kernels at each edge, as
    # chip_smoke.device_profile does, and some of each edge must be kept
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        time.sleep(0.25)
        for _ in range(200):
            torch.cuda._sleep(100)
        mmad_mod.mmad(a, b, None, torch.float32)
        for _ in range(200):
            torch.cuda._sleep(100)
        torch.cuda.synchronize()
        time.sleep(0.25)
    names = [e.name for e in sorted(prof.events(),
                                    key=lambda e: e.time_range.start)
             if e.device_type == torch.autograd.DeviceType.CUDA]
    work = [i for i, name in enumerate(names) if "spin_kernel" not in name]
    assert work and work[0] > 0 and work[-1] < len(names) - 1, names[:3]
    names = [name for name in names if "mmad" in name]
    want = (["mmad_fp8_transpose_kernel", "mmad_fp8_kernel<"] if major == "n"
            else ["mmad_fp8_kernel<"])
    assert len(names) == len(want), names
    assert all(w in name for w, name in zip(want, names)), names


# ---------------------------------------------------------------------------
# every compiled tensor-core instance: the geometries a card-view plan names
# ---------------------------------------------------------------------------

TC16 = [i for i in mmad_mod.TC_INSTANCES if i.family == "16bit"]
TCF8 = [i for i in mmad_mod.TC_INSTANCES if i.family == "e4m3"]


def _instance_id(inst):
    return f"{inst.bm}x{inst.bn}x{inst.bk}s{inst.stages}"


def _held_at(a, b, inst, fp8, cuda):
    """`mmad` at instance `inst`, fp32 and bf16 out: the route it plans is
    that instance's, each launch is recorded as named by the caller, a
    second launch is bitwise the first, and C is the plain version's
    within the tensor cores' tolerance."""
    m, k = a.shape
    n = b.shape[1]
    block = (inst.bm, inst.bn, inst.bk)
    launch = mmad_mod.plan_launch(
        m, n, k, block, mmad_mod._num_sms(cuda), mmad_mod.b_layout(b),
        b.element_size(), mmad_mod.wgmma_b_major(a, b),
        mmad_mod.tile_vectors(a, b), inst.stages)
    assert launch.instance == inst
    variant = mmad_mod.WGMMA_FP8 if fp8 else mmad_mod.WGMMA
    assert launch[0] == variant
    for out_dtype in (torch.float32, torch.bfloat16):
        mmad_mod.reset_launch_count()
        got = mmad_mod.mmad(a, b, block, out_dtype, inst.stages)
        again = mmad_mod.mmad(a, b, block, out_dtype, inst.stages)
        torch.cuda.synchronize()
        assert mmad_mod.geometry_counts() == {
            (variant, (m, n, k), inst, True): 2}
        assert torch.equal(got, again)
        _assert_close(got, ref.mmad_ref(a, b, out_dtype), k, out_dtype,
                      tensor_cores=not fp8, fp8=fp8)


@pytest.mark.parametrize("majors", mmad_mod.WGMMA_MAJORS,
                         ids=[f"A{a}B{b}" for a, b in mmad_mod.WGMMA_MAJORS])
@pytest.mark.parametrize("dtype_name", ["bfloat16", "float16"])
@pytest.mark.parametrize("inst", TC16, ids=[_instance_id(i) for i in TC16])
def test_every_16bit_instance_matches_plain(cuda, inst, dtype_name, majors):
    """Each 16-bit instance on M, N and K that are multiples of none of its
    tile edges or its K step (296 x 520 x 1000: partial tiles on both
    edges, a ring wrapped several times; each a multiple of 8, so a tensor
    map describes either major), A K- or M-contiguous, B N- or
    K-contiguous, in the (A, B) majors the kernel is built for."""
    dtype = getattr(torch, dtype_name)
    m, k, n = 296, 1000, 520
    g = torch.Generator(device=cuda).manual_seed(m + TC16.index(inst))
    a = _draw((m, k), dtype, g, cuda) if majors[0] == "k" \
        else _draw((k, m), dtype, g, cuda).T
    b = _draw((k, n), dtype, g, cuda) if majors[1] == "n" \
        else _draw((n, k), dtype, g, cuda).T
    assert (mmad_mod.wgmma_a_major(a), mmad_mod.wgmma_b_major(a, b)) == majors
    _held_at(a, b, inst, False, cuda)


@pytest.mark.parametrize("mkn", [(300, 1000, 520), (2048, 1000, 2100)],
                         ids=["split", "unsplit"])
@pytest.mark.parametrize("major", ["n", "k"])
@pytest.mark.parametrize("inst", TCF8, ids=[_instance_id(i) for i in TCF8])
def test_every_fp8_instance_matches_plain(cuda, inst, major, mkn):
    """Each e4m3 instance, B N-major (transposed in the call) or K-major,
    on ragged shapes whose tiles split K (few tiles) or do not, against
    the plain version within `fp8_tensor_core_atol`."""
    m, k, n = mkn
    g = torch.Generator(device=cuda).manual_seed(m + n + TCF8.index(inst))
    a, b = _fp8_operands(m, k, n, major, g, cuda)
    _held_at(a, b, inst, True, cuda)


@pytest.mark.parametrize("block,stages,dtype_name", [
    ((128, 128, 128), None, "bfloat16"),     # no 16-bit K step of 128
    ((128, 256, 64), 6, "bfloat16"),         # the tile, not its ring depth
    ((128, 256, 64), None, "float32"),       # the SIMT tile route
    ((64, 128, 128), None, "float8_e4m3fn"),  # no 64-row fp8 tile
], ids=["bf16-bk128", "bf16-6-stages", "fp32", "fp8-bm64"])
def test_a_geometry_outside_the_instances_raises(cuda, block, stages,
                                                 dtype_name):
    """A geometry the card does not compile, or one given to operands the
    tensor cores do not take, raises `ValueError` naming it, and nothing
    launches: the launch never runs another geometry in its place."""
    dtype = getattr(torch, dtype_name)
    g = torch.Generator(device=cuda).manual_seed(9)
    a = _draw((256, 512), dtype, g, cuda)
    b = _draw((512, 384), dtype, g, cuda)
    mmad_mod.reset_launch_count()
    with pytest.raises(ValueError, match=r"\d+"):
        mmad_mod.mmad(a, b, block, torch.float32, stages)
    assert mmad_mod.launch_count() == 0 and not mmad_mod.geometry_counts()
