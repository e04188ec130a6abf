"""On-card tests of the port's CUDA kernel (marker `gpu`).

Each test asks the `cuda` fixture for the card and skips, with its reason,
where there is none (the CPU test run). On an H100 they build `mmad` from
`src/repro_torch/kernels/csrc/mmad.cu` and hold it against its plain
version on the same tensors: rtol 1e-5 and atol 1e-5·sqrt(K) (fp32
accumulation of fp32-exact products in another order), plus one output ulp
for bf16 out. Run them on the card with

    PYTHONPATH=src python -m pytest -q -m gpu tests/test_torch_gpu.py

This file imports neither jax nor the JAX package.
"""
import importlib
import math

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
    # (m, k, n, block, transposed B)
    (4, 2048, 2048, (4, 128, 256), False),      # row stream, split K
    (4, 2048, 256, (4, 256, 128), False),
    (4, 4096, 512, (4, 128, 512), False),
    (4, 2048, 3000, (4, 512, 256), True),       # column stream, split K
    (2, 256, 384, (2, 128, 128), False),
    (48, 120, 192, (24, 96, 40), False),        # tile kernel from here on
    (5, 130, 7, (8, 128, 128), False),
    (200, 300, 260, (128, 128, 128), True),
]


def _draw(shape, dtype, g, dev):
    if dtype == torch.int8:
        return torch.randint(-8, 9, shape, generator=g, device=dev).to(dtype)
    return torch.randn(shape, generator=g, device=dev).to(dtype)


def _assert_close(got, want, k, out_dtype=torch.float32):
    ulp = {torch.bfloat16: 2.0 ** -7, torch.float16: 2.0 ** -10}.get(
        out_dtype, 0.0)
    err = (got.float() - want.float()).abs()
    tol = 1e-5 * math.sqrt(k) + (1e-5 + ulp) * want.float().abs()
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
    n = 2 * mmad_mod._num_sms(cuda) * 512         # over two CTAs per SM
    g = torch.Generator(device=cuda).manual_seed(k + transposed)
    a = _draw((m, k), dtype, g, cuda)
    b = _draw((n, k), dtype, g, cuda).T if transposed else _draw((k, n), dtype,
                                                              g, cuda)
    variant, _, splits = mmad_mod.plan_launch(
        m, n, k, (4, 512, 256), mmad_mod._num_sms(cuda), mmad_mod.b_layout(b),
        b.element_size())
    assert splits == 1
    assert variant == (mmad_mod.COL_STREAM if transposed
                       else mmad_mod.ROW_STREAM)
    for out_dtype in (torch.float32, torch.bfloat16):
        got = mmad_mod.mmad(a, b, (4, 512, 256), out_dtype)
        _assert_close(got, ref.mmad_ref(a, b, out_dtype), k, out_dtype)


@pytest.mark.parametrize("out_name", ["bfloat16", "float16", "float32"])
def test_kernel_output_dtypes(cuda, out_name):
    out_dtype = getattr(torch, out_name)
    g = torch.Generator(device=cuda).manual_seed(1)
    a = _draw((4, 1024), torch.bfloat16, g, cuda)
    b = _draw((1024, 640), torch.bfloat16, g, cuda)
    got = mmad_mod.mmad(a, b, (4, 128, 256), out_dtype=out_dtype)
    assert got.dtype == out_dtype
    _assert_close(got, ref.mmad_ref(a, b, out_dtype), 1024, out_dtype)


def test_mixed_operand_dtypes(cuda):
    """_cast_operand never narrows, so fp32 activations can meet bf16
    weights: the kernel reads each operand at its own dtype."""
    g = torch.Generator(device=cuda).manual_seed(2)
    a = _draw((4, 512), torch.float32, g, cuda)
    b = _draw((512, 256), torch.bfloat16, g, cuda)
    _assert_close(mmad_mod.mmad(a, b, (4, 128, 128), torch.float32),
                  ref.mmad_ref(a, b, torch.float32), 512)


def test_local_matmul_runs_the_kernel_with_grads(cuda):
    g = torch.Generator(device=cuda).manual_seed(3)
    a = _draw((8, 256), torch.float32, g, cuda).requires_grad_(True)
    b = _draw((256, 96), torch.float32, g, cuda).requires_grad_(True)
    kernel = InnerKernel(8, 64, 128, dtype="float32")
    before = mmad_mod.launch_count()
    out = ops.local_matmul(a, b, kernel)
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
