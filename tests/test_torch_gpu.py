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
    # (m, k, n, block, transposed B)
    (4, 2048, 2048, (4, 128, 256), False),      # row stream, split K
    (4, 2048, 256, (4, 256, 128), False),
    (4, 4096, 512, (4, 128, 512), False),
    (4, 2048, 3000, (4, 512, 256), True),       # column stream
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
    # a row-stream tile per SM
    n = mmad_mod._num_sms(cuda) * mmad_mod.ROW_VECS * (16 // dtype.itemsize)
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
        m, n, k, (4, 128, 256), mmad_mod._num_sms(cuda), mmad_mod.b_layout(b),
        b.element_size())
    assert variant != mmad_mod.TILE and splits > 1
    stream = torch.cuda.current_stream(cuda).cuda_stream
    first = mmad_mod.mmad(a, b, (4, 128, 256), torch.float32)
    for _ in range(3):
        again = mmad_mod.mmad(a, b, (4, 128, 256), torch.float32)
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
        m, n, k, (4, 512, 256), mmad_mod._num_sms(cuda), mmad_mod.b_layout(b),
        b.element_size())
    assert splits > 1
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
    tied weight read in place as `embed.T` (256000 x 2048 bf16)."""
    g = torch.Generator(device=cuda).manual_seed(4)
    a = _draw((1024, 2048), torch.bfloat16, g, cuda)
    embed = _draw((256000, 2048), torch.bfloat16, g, cuda)
    block = (512, 128, 512)
    variant, _, _ = mmad_mod.plan_launch(
        1024, 256000, 2048, block, mmad_mod._num_sms(cuda),
        mmad_mod.b_layout(embed.T), 2)
    assert variant == mmad_mod.TILE
    got = mmad_mod.mmad(a, embed.T, block, torch.float32)
    torch.cuda.synchronize()
    _assert_close(got, ref.mmad_ref(a, embed.T, torch.float32), 2048)


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
    """One routed train step (bf16 smoke config) on the card, with the tile
    kernel and the fp32 backward, against the same step on the CPU (the
    plain versions): loss and grad norm within 2e-2 relative, the serve
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
            assert mmad_mod.launch_count() == ctx.stats.executed_gemm == 2 * (
                7 * cfg.n_layers + 1)
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
