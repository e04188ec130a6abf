"""Parity of training deepseek-v2-236b (MLA in its naive form under a
backward) in the port with the JAX reference, and a CPU rehearsal of
`chip_smoke.py`'s deepseek-v2-236b train phase.

One routed train step of deepseek-v2-236b-smoke (1 dense + 2 MoE layers,
MLA with `q_lora_rank`: `mla.q_down`, `mla.q_up`, `mla.kv_down`,
`mla.k_rope`, `mla.k_up`, `mla.v_up` and `mla.o` through `pmm`, attention
at head dim dn + dr for q and k and dn for v) through the launcher's path
(`launch.train.warm_train_plans`, then `make_train_step`: `loss_and_grads`
with per-layer remat, AdamW) against the reference's jitted
`make_train_step`, from the same weights (made from a numpy seed at the reference's
initial scales) on the same `SyntheticLM` batch, on an Auto-axis 1x1 mesh. The reference's gradients are read from its
first AdamW moment (mu = (1 - b1) x the clipped gradient; the clip factor
from its grad norm). Tolerances as in tests/test_torch_moe_train.py: at
fp32 the loss within 1e-5 relative, the grad norm within 1e-5, and every
gradient leaf, every first moment over (1 - b1) and the square root of
every second moment over (1 - b2) at rtol = atol = 1e-4 (the K-scaled
summation-order tolerance of ROADMAP.md queue 3), the port's expert
choices equal to the reference's; at bf16 the loss within 1e-3, the grad
norm within 2e-2, the gradients and both moments within 2e-2 relative L2
over all leaves and MLA's leaves each within 5e-2 (each GEMM output and
each gradient rounds to bf16, 2^-8 relative, at other points), with the reference's expert choices pinned into the port
(bf16 roundings move near-tied gates across each other); the parameters
after the step with `assert_first_adam_step`.

The rehearsal runs `chip_smoke.train_model` on the smoke model at the card
phase's depth (`V2_TRAIN_LAYERS`) with CPU tensors and the stubs of
tests/test_torch_moe_train.py's rehearsals.
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
from test_torch_moe_train import (_chip_smoke, _np, _port_named,  # noqa: E402
                                  _rehearse_train_phase, _rel, _rel_l2)

ARCH = "deepseek-v2-236b"
BATCH, SEQ = 2, 32
MLA_TAGS = {"mla.q_down", "mla.q_up", "mla.kv_down", "mla.k_rope",
            "mla.k_up", "mla.v_up", "mla.o"}


def numpy_params(jcfg, seed: int = 0):
    """The reference's parameter tree (its leaves' shapes and dtypes from
    `init_params` traced abstractly, which compiles nothing), filled from a
    numpy seed at `init_params`' scales: the norms' scales 1 + 0.1 N(0, 1),
    the embedding N(0, 1 / d_model), every other weight N(0, 1 / fan-in)."""
    shapes = jax.eval_shape(lambda key: jmodel.init_params(key, jcfg),
                            jax.random.PRNGKey(0))
    rng = np.random.default_rng(seed)

    def fill(path, leaf):
        name = jax.tree_util.keystr(path)
        x = rng.standard_normal(leaf.shape)
        if name.endswith("['scale']"):
            x = 1 + 0.1 * x
        else:
            x = x * leaf.shape[-1 if name == "['embed']" else -2] ** -0.5
        return jnp.asarray(x.astype(np.float32), leaf.dtype)
    return jax.tree_util.tree_map_with_path(fill, shapes)


def _flat(tree, names):
    return np.concatenate([tree[k].ravel() for k in names])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_routed_mla_train_step_matches_reference(dtype, tmp_path, capsys,
                                                monkeypatch):
    jcfg = dataclasses.replace(jconfigs.smoke_config(ARCH),
                               dtype=getattr(jnp, dtype))
    tcfg = dataclasses.replace(tconfigs.smoke_config(ARCH),
                               dtype=getattr(torch, dtype))
    fp32 = dtype == "float32"
    assert tcfg.attn == "mla" and tcfg.q_lora_rank
    jparams = numpy_params(jcfg)
    tparams = tmodel.make_trainable(tmodel.params_from_numpy(
        jax.tree.map(np.asarray, jparams), tcfg, device="cpu"))
    old = {k: _np(v).copy() for k, v in tparams.named_parameters()}
    bf16 = {k for k, v in tparams.named_parameters()
            if v.dtype == torch.bfloat16}
    routers = [k for k in old if k.endswith(".moe.router")]
    assert len(routers) == tcfg.n_layers - tcfg.n_dense_layers == 2
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

    # the reference's step, its expert choices recorded as its forward
    # routes each MoE layer (its remat recomputation routes them again)
    seen = []
    real_top_k = jax.lax.top_k

    def top_k(gates, k):
        out = real_top_k(gates, k)
        jax.debug.callback(lambda i: seen.append(np.array(i)), out[1])
        return out
    monkeypatch.setattr(jax.lax, "top_k", top_k)
    with jctx.gemm_context(jc):
        jp, jst, _, jm = jax.jit(jsteps.make_train_step(jcfg, jopt))(
            jparams, jadamw.init(jparams), None, jb)
        jax.block_until_ready(jm["loss"])
    monkeypatch.setattr(jax.lax, "top_k", real_top_k)
    jchoices = seen[:len(routers)]

    # fp32: the port routes on its own and must choose as the reference
    # did; bf16: the reference's choices are pinned (see the docstring)
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
    assert MLA_TAGS | {"moe.router", "lm_head.chunked"} <= {
        tag for tag, _ in keys}
    assert "mla.sdpa" in {tag for tag, _ in tc.stats.attn_observed}

    names = list(old)
    loss_tol, norm_tol, grad_rel_l2 = (1e-5, 1e-5, None) if fp32 else (
        1e-3, 2e-2, 2e-2)
    assert _rel(tl, jm["loss"]) <= loss_tol
    assert _rel(tm["loss"], jm["loss"]) <= loss_tol
    assert _rel(tm["grad_norm"], jm["grad_norm"]) <= norm_tol

    # the reference's unclipped grads: its clipped ones (mu / (1 - b1))
    # over the clip factor its grad norm gave
    factor = min(1.0, jopt.clip_norm / (float(jm["grad_norm"]) + 1e-9))
    jmu, jnu = _port_named(jst.mu), _port_named(jst.nu)
    want = {"grads": {k: jmu[k] / (1 - jopt.b1) / factor for k in names},
            "mu": {k: jmu[k] / (1 - jopt.b1) for k in names},
            "sqrt nu": {k: np.sqrt(jnu[k] / (1 - jopt.b2)) for k in names}}
    got = {"grads": {k: _np(tg[k]) for k in names},
           "mu": {k: _np(tst.mu[k]) / (1 - topt.b1) for k in names},
           "sqrt nu": {k: np.sqrt(_np(tst.nu[k]) / (1 - topt.b2))
                       for k in names}}
    assert list(tg) == names and set(jmu) == set(names)
    for k in routers:
        assert tg[k].dtype == torch.float32
    for what in want:
        if fp32:
            for k in names:
                np.testing.assert_allclose(got[what][k], want[what][k],
                                           rtol=1e-4, atol=1e-4,
                                           err_msg=f"{what} {k}")
        else:
            assert _rel_l2(_flat(got[what], names),
                           _flat(want[what], names)) <= grad_rel_l2, what
            # MLA's own leaves one by one: a narrow leaf (w_kr, dr = 8
            # columns at smoke width) averages over few elements, so its
            # bf16 noise reads larger (2.5e-2 on these weights)
            for k in [n for n in names if ".attn." in n]:
                assert _rel_l2(got[what][k], want[what][k]) <= 5e-2, \
                    (what, k)

    new_t = {k: _np(v) for k, v in tp.named_parameters()}
    check = dict(old=old, new_j=_port_named(jp), g_t=got["mu"],
                 g_j=want["mu"], lr=float(jm["lr"]),
                 wd=topt.weight_decay, eps=topt.eps, bf16=bf16)
    assert_first_adam_step(new_t=new_t, **check)
    with pytest.raises(AssertionError):
        assert_first_adam_step(new_t=old, **check)


def test_chip_smoke_v2_train_phase_rehearsed_on_cpu(monkeypatch, tmp_path,
                                                    capsys):
    """`chip_smoke.train_model` on deepseek-v2-236b-smoke cut to the card
    phase's depth: launches = routed dispatches (forward and remat
    recompute) + 2 per bf16 backward call, any fp32 router's backward
    counted apart, the routed trajectory held to the unrouted one, and
    the profile told the step's launches."""
    depth = _chip_smoke(monkeypatch).V2_TRAIN_LAYERS
    cfg = dataclasses.replace(tconfigs.smoke_config(ARCH), n_layers=depth)
    (per_step, bwd_per_step, table, summary), profiled = \
        _rehearse_train_phase(monkeypatch, tmp_path, ARCH, cfg)
    out = capsys.readouterr().out
    dense = min(cfg.n_layers, cfg.n_dense_layers)
    moe_layers = cfg.n_layers - dense
    # per forward: MLA's 7 GEMMs per layer, the dense MLP's 3, a router +
    # 3 shared experts per MoE layer, one lm_head chunk (seq 64 < 512)
    dispatches = 7 * cfg.n_layers + 3 * dense + 4 * moe_layers + 1
    assert per_step == 2 * dispatches + 2 * (dispatches - moe_layers)
    assert bwd_per_step == 2 * (dispatches - moe_layers)
    assert profiled == (per_step, 2 * moe_layers, moe_layers)
    shapes = {key[:3] for key in table}
    d, r = cfg.d_model, cfg.kv_lora_rank
    dn, dr, h = cfg.nope_head_dim, cfg.rope_head_dim, cfg.n_heads
    assert {(128, cfg.q_lora_rank, d), (128, h * (dn + dr), cfg.q_lora_rank),
            (128, r, d), (128, dr, d), (128, h * dn, r),
            (128, d, h * dn)} <= shapes
    assert ("same_input_flips" in summary) == (moe_layers > 0)
    assert "train trajectory on the fixed batch" in out
