"""Parity of training an MoE model in the port with the JAX reference, and a
CPU rehearsal of `chip_smoke.py`'s MoE train phase.

One routed train step of deepseek-moe-16b-smoke (1 dense + 2 MoE layers:
the fp32 router through `pmm`, the capacity-bounded one-hot dispatch, the
expert einsums, the shared experts) through the launcher's path
(`launch.train.warm_train_plans` over the MoE train workload, then
`make_train_step`: `loss_and_grads` with per-layer remat, AdamW) against
the reference's `jax.value_and_grad(loss_fn)` and its jitted step, from the
same weights on the same `SyntheticLM` batch. Tolerances as in
tests/test_torch_train.py: at fp32 the loss within 1e-5 relative and every
grad (the fp32 router's included) at rtol = atol = 1e-4 (the K-scaled
summation-order tolerance of ROADMAP.md queue 3), the port's expert
choices equal to the reference's; at bf16 the loss within 1e-3 relative and
the grads within 2e-2 relative L2 (each GEMM output and each gradient
rounds to bf16, 2^-8 relative, at other points), the fp32 router's grad
alone within 2e-2 relative L2 too, with the reference's expert choices
pinned into the port (bf16 roundings move near-tied gates across each
other, and a flipped choice is another computation, not an error); the
parameters after the step with `assert_first_adam_step`. With tokens
dropped by the capacity bound (capacity factor 0.5) too.

The rehearsal runs `chip_smoke.train_model` on the smoke model at the
card phase's depth (`MOE_TRAIN_LAYERS`) with CPU tensors and the stubs the
verify skill names: `ops.mmad` counted (the CPU path counts no launches),
the tensor-core backward taken for bf16 operands (so the census holds as
on the card), the profile stubbed. The routed run records its expert
choices and the unrouted run takes them pinned. A dense rehearsal on
gemma-2b-smoke runs the same phase with nothing to record or pin.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from jax.sharding import AxisType  # noqa: E402

from repro import configs as jconfigs  # noqa: E402
from repro.data import pipeline as jdata  # noqa: E402
from repro.deploy.warmup import build_planner as jbuild_planner  # noqa: E402
from repro.models import model as jmodel  # noqa: E402
from repro.models import shard_ctx as jctx  # noqa: E402
from repro.optim import adamw as jadamw  # noqa: E402
from repro.train import steps as jsteps  # noqa: E402
from repro_torch import configs as tconfigs  # noqa: E402
from repro_torch.launch import mesh as tmesh  # noqa: E402
from repro_torch.launch import train as ttrain  # noqa: E402
from repro_torch.models import model as tmodel  # noqa: E402
from repro_torch.models import moe as tmoe  # noqa: E402
from repro_torch.models import shard_ctx as tctx  # noqa: E402
from repro_torch.models.matmul import pmm  # noqa: E402
from repro_torch.optim import adamw as tadamw  # noqa: E402
from repro_torch.train import steps as tsteps  # noqa: E402
from test_torch_gpu import assert_first_adam_step  # noqa: E402
from test_torch_serve import ROOT  # noqa: E402

ARCH = "deepseek-moe-16b"
BATCH, SEQ = 4, 32
STACKED = ("layers", "dense_layers", "moe_layers")


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(x, np.float32)


def _rel(got, want):
    return abs(float(_np(got)) - float(_np(want))) / abs(float(_np(want)))


def _rel_l2(got, want):
    return float(np.linalg.norm(got - want) / np.linalg.norm(want))


def _port_named(tree):
    """The reference's parameter-shaped pytree (grads, moments) under the
    port's names: block i of a stacked group G is `G.i.<path>`."""
    out = {}
    for name, leaf in tmodel._flatten(tree):
        group, _, rest = name.partition(".")
        if group in STACKED:
            for i in range(len(leaf)):
                out[f"{group}.{i}.{rest}"] = _np(leaf[i])
        else:
            out[name] = _np(leaf)
    return out


CASES = [("float32", 1.25), ("float32", 0.5), ("bfloat16", 1.25)]


@pytest.mark.parametrize("dtype,cf", CASES,
                         ids=[f"{d}-cf{cf}" for d, cf in CASES])
def test_routed_moe_train_step_matches_reference(dtype, cf, tmp_path, capsys,
                                                monkeypatch):
    jcfg = dataclasses.replace(jconfigs.smoke_config(ARCH),
                               dtype=getattr(jnp, dtype), capacity_factor=cf)
    tcfg = dataclasses.replace(tconfigs.smoke_config(ARCH),
                               dtype=getattr(torch, dtype), capacity_factor=cf)
    fp32 = dtype == "float32"
    jparams = jmodel.init_params(jax.random.PRNGKey(0), jcfg)
    tparams = tmodel.make_trainable(tmodel.params_from_numpy(
        jax.tree.map(np.asarray, jparams), tcfg, device="cpu"))
    old = {k: _np(v).copy() for k, v in tparams.named_parameters()}
    bf16 = {k for k, v in tparams.named_parameters()
            if v.dtype == torch.bfloat16}
    routers = [k for k in old if k.endswith(".moe.router")]
    assert len(routers) == tcfg.n_layers - tcfg.n_dense_layers
    assert all(tparams.get_parameter(k).dtype == torch.float32
               for k in routers)
    batch = jdata.SyntheticLM(jdata.DataConfig(
        vocab=jcfg.vocab, seq_len=SEQ, global_batch=BATCH)).batch(0)
    opt = dict(lr=1e-3, warmup_steps=5, total_steps=10)
    jopt, topt = jadamw.AdamWConfig(**opt), tadamw.AdamWConfig(**opt)

    # one plan cache, warmed by the port's launcher path, serves both
    cache = str(tmp_path / "plans")
    tplanner = ttrain.warm_train_plans(tcfg, BATCH, SEQ, cache, (4, 4), 12)
    jc = jctx.GemmContext(
        mesh=jax.make_mesh((1, 1), ("data", "model"),
                           axis_types=(AxisType.Auto,) * 2),
        planner=jbuild_planner(cache, (4, 4), 12))
    tc = tctx.GemmContext(mesh=tmesh.make_host_mesh("cpu"), planner=tplanner)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    tb = {k: torch.from_numpy(v).long() for k, v in batch.items()}

    # the reference's expert choices, recorded as its forward routes each
    # MoE layer (its remat recomputation routes them again, identically)
    seen = []
    real_top_k = jax.lax.top_k

    def top_k(gates, k):
        out = real_top_k(gates, k)
        jax.debug.callback(lambda i: seen.append(np.array(i)), out[1])
        return out
    monkeypatch.setattr(jax.lax, "top_k", top_k)
    with jctx.gemm_context(jc):
        jl, jg = jax.jit(jax.value_and_grad(
            lambda p: jsteps.loss_fn(p, jb, jcfg)))(jparams)
        jax.block_until_ready(jl)
        monkeypatch.setattr(jax.lax, "top_k", real_top_k)
        jp, jst, _, jm = jax.jit(jsteps.make_train_step(jcfg, jopt))(
            jparams, jadamw.init(jparams), None, jb)
    jchoices = seen[:len(routers)]

    # at fp32 the port routes on its own and must choose as the reference
    # did; at bf16 the router's inputs are bf16 activations rounded at
    # other points, which move near-tied gates across each other (a few
    # token-layers of 128 on these weights), so the reference's choices
    # are pinned and the step compares the arithmetic around them
    layer_of = {id(block.moe): j for j, block in
                enumerate(tparams.moe_layers)}
    real_route = tmoe.route

    def route(p, xt, c):
        want = torch.from_numpy(jchoices[layer_of[id(p)]]).long()
        if fp32:
            topv, topi = real_route(p, xt, c)
            np.testing.assert_array_equal(topi.numpy(), want.numpy())
            return topv, topi
        gates = torch.softmax(pmm(xt.float(), p.router, tag="moe.router"),
                              dim=-1)
        topv = gates.gather(-1, want)
        return topv / torch.clamp(topv.sum(-1, keepdim=True), min=1e-9), want
    monkeypatch.setattr(tmoe, "route", route)
    with tctx.gemm_context(tc):
        tl, tg = tsteps.loss_and_grads(tparams, tb, tcfg)
        tp, tst, _, tm = tsteps.make_train_step(tcfg, topt)(
            tparams, tadamw.init(tparams), None, tb)
    capsys.readouterr()
    assert tc.stats.resolve_rate == jc.stats.resolve_rate == 1.0
    assert tc.stats.silent_degrades == 0
    keys = {(tag, tuple(dataclasses.astuple(s)))
            for tag, s in tc.stats.observed}
    assert keys == {(tag, tuple(dataclasses.astuple(s)))
                    for tag, s in jc.stats.observed}
    assert {"moe.router", "moe.expert_gate", "moe.shared_down",
            "lm_head.chunked"} <= {tag for tag, _ in keys}

    names = list(old)
    jg = _port_named(jg)
    assert list(tg) == names and set(jg) == set(names)
    assert _rel(tl, jl) <= (1e-5 if fp32 else 1e-3)
    assert _rel(tm["loss"], jm["loss"]) <= (1e-5 if fp32 else 1e-3)
    assert _rel(tm["grad_norm"], jm["grad_norm"]) <= (1e-5 if fp32 else 2e-2)
    for k in routers:
        assert tg[k].dtype == torch.float32
    if fp32:
        for k in names:
            np.testing.assert_allclose(_np(tg[k]), jg[k], rtol=1e-4,
                                       atol=1e-4, err_msg=k)
    else:
        flat_t = np.concatenate([_np(tg[k]).ravel() for k in names])
        flat_j = np.concatenate([jg[k].ravel() for k in names])
        assert _rel_l2(flat_t, flat_j) <= 2e-2
        for k in routers:
            assert _rel_l2(_np(tg[k]), jg[k]) <= 2e-2, k

    # the grads the optimizer saw (clipped): mu / (1 - b1)
    jmu = _port_named(jst.mu)
    g_t = {k: _np(tst.mu[k]) / (1 - topt.b1) for k in names}
    g_j = {k: jmu[k] / (1 - jopt.b1) for k in names}
    new_t = {k: _np(v) for k, v in tp.named_parameters()}
    check = dict(old=old, new_j=_port_named(jp), g_t=g_t, g_j=g_j,
                 lr=float(jm["lr"]), wd=topt.weight_decay, eps=topt.eps,
                 bf16=bf16)
    assert_first_adam_step(new_t=new_t, **check)
    with pytest.raises(AssertionError):
        assert_first_adam_step(new_t=old, **check)


def _chip_smoke(monkeypatch):
    import importlib
    monkeypatch.syspath_prepend(str(ROOT))
    return importlib.import_module("chip_smoke")


def _rehearse_train_phase(monkeypatch, tmp_path, arch, cfg):
    """`chip_smoke.train_model` on `cfg` with CPU tensors and the verify
    skill's stubs; returns what it returns and the arguments it handed
    the (stubbed) device profile after its step's launches."""
    import importlib
    chip_smoke = _chip_smoke(monkeypatch)
    mmad_mod = importlib.import_module("repro_torch.kernels.mmad")
    from repro_torch.kernels import ops
    from repro_torch.obs import set_tracer
    real = ops.mmad

    def counted(a, b, *args, **kw):
        mmad_mod._launches += 1
        return real(a, b, *args, **kw)
    monkeypatch.setattr(ops, "mmad", counted)
    monkeypatch.setattr(ops, "tensor_core_backward",
                        lambda a, b: a.dtype == b.dtype == torch.bfloat16)
    profiled = []
    monkeypatch.setattr(chip_smoke, "train_profile", lambda *a, **k: (
        profiled.append(a[6:]) or {"busy_ms": 1, "wall_ms": 1,
                                    "mmad_ms": 0}))
    monkeypatch.setattr(chip_smoke, "ROOT", tmp_path)
    try:
        out = chip_smoke.train_model(
            torch, mmad_mod, torch.device("cpu"),
            ["--arch", arch, "--smoke", "--device", "cpu", "--batch", "2",
             "--seq", "64"], cfg=cfg)
    finally:
        tctx.set_gemm_context(None)
        set_tracer(None)
    assert len(profiled) == 1
    return out, profiled[0]


def test_chip_smoke_dense_train_phase_rehearsed_on_cpu(monkeypatch, tmp_path,
                                                       capsys):
    """The same phase on gemma-2b-smoke (no experts, so nothing recorded
    or pinned): launches = routed dispatches + 2 per backward call, no
    fp32 GEMM for the profile to expect, the routed trajectory held to the
    unrouted one run after it."""
    cfg = tconfigs.smoke_config("gemma-2b")
    (per_step, bwd_per_step, table, summary), profiled = \
        _rehearse_train_phase(monkeypatch, tmp_path, "gemma-2b", cfg)
    out = capsys.readouterr().out
    assert profiled == (per_step, 0, 0)
    # per forward: q/k/v/o and gate/up/down per layer, one lm_head chunk;
    # run in the forward and the remat recompute, each with a backward call
    dispatches = 7 * cfg.n_layers + 1
    assert per_step == 2 * dispatches + 2 * dispatches
    assert bwd_per_step == 2 * dispatches
    assert 2 * sum(r["backward_calls"] for r in table.values()) == \
        bwd_per_step
    assert all(r["dtype"] == torch.bfloat16 for r in table.values())
    assert "same_input_flips" not in summary
    assert "train trajectory on the fixed batch" in out


def test_chip_smoke_moe_train_phase_rehearsed_on_cpu(monkeypatch, tmp_path,
                                                     capsys):
    """`chip_smoke.train_model` on deepseek-moe-16b-smoke cut to the card
    phase's depth: launches = routed dispatches + 2 per bf16 backward call,
    the fp32 router's backward counted apart (fp32 `torch.matmul`, no
    launch), the routed trajectory held to the unrouted one with the
    routed run's expert choices pinned into it, no same-input flip, and the
    profile told the router's launches and fp32 backward calls per step
    (from which it expects the step's fp32 library GEMMs)."""
    cfg = dataclasses.replace(tconfigs.smoke_config(ARCH),
                              n_layers=_chip_smoke(monkeypatch)
                              .MOE_TRAIN_LAYERS)
    (per_step, bwd_per_step, table, summary), profiled = \
        _rehearse_train_phase(monkeypatch, tmp_path, ARCH, cfg)
    out = capsys.readouterr().out
    moe_layers = cfg.n_layers - cfg.n_dense_layers
    # per forward: q/k/v/o per layer, the dense MLP, router + 3 shared
    # experts per MoE layer, one lm_head chunk (seq 64 < 512)
    dispatches = 4 * cfg.n_layers + 3 * cfg.n_dense_layers + 4 * moe_layers + 1
    assert per_step == 2 * dispatches + 2 * (dispatches - moe_layers)
    assert bwd_per_step == 2 * (dispatches - moe_layers)
    router = [r for r in table.values() if r["dtype"] == torch.float32]
    assert len(router) == 1
    assert router[0]["count"] == 2 * moe_layers
    assert router[0]["fp32_backward_calls"] == moe_layers
    assert router[0]["backward_calls"] == 0
    assert summary["same_input_flips"] == 0
    assert summary["token_layers"] > 0
    assert profiled == (per_step, 2 * moe_layers, moe_layers)
    assert "ran on fp32 torch.matmul" in out
    assert "train trajectory on the fixed batch" in out
