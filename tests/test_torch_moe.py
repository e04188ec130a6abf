"""Parity of the port's MoE layer and MoE model with the JAX reference.

Both packages get the same numpy-seeded inputs (the reference's parameter
pytree carried into the port). Routing is discrete, so it is compared
first and exactly:

- the top-k expert indices, against the reference's `jax.lax.top_k`
  (recorded while its `apply_moe` runs), after checking that the inputs
  leave a clear margin between the k-th and (k+1)-th gates (a margin
  within fp32 summation noise would let either framework pick either);
- ties go to the lower expert index in both (one tie made on purpose);
- each choice's buffer position and the capacity drop mask, against the
  reference's position lines (`repro/models/moe.py:101-107`, restated in
  jnp here) on the reference's indices;

then the values: `apply_moe`'s output and the grads of x and of every
parameter, fp32 at rtol = atol = 1e-4 (the K-scaled summation-order
tolerance of ROADMAP.md queue 3), bf16 at the serve tolerances (output
rtol 2e-2, atol 5e-2; grads within 2e-2 relative L2: every einsum output
is rounded to bf16, 2^-8 relative, at other points), with and without
tokens dropped. `_capacity` and `_dp_groups` agree with the reference's
and with `deploy.planner.moe_dispatch_geometry`. The whole smoke model
(1 dense + 2 MoE layers) carries its weights across, decodes routed and
runs its forward as the reference does (the serve parity tolerances of
tests/test_torch_serve.py).
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro import configs as jconfigs  # noqa: E402
from repro.models import model as jmodel  # noqa: E402
from repro.models import moe as jmoe  # noqa: E402
from repro_torch import configs as tconfigs  # noqa: E402
from repro_torch.deploy.planner import moe_dispatch_geometry  # noqa: E402
from repro_torch.launch.mesh import HostMesh  # noqa: E402
from repro_torch.models import model as tmodel  # noqa: E402
from repro_torch.models import moe as tmoe  # noqa: E402
from repro_torch.models import shard_ctx as tctx  # noqa: E402
from test_torch_serve import (_decisions, _decode_jax,  # noqa: E402
                              _decode_torch)

ARCH = "deepseek-moe-16b"
TOL = {"float32": dict(rtol=1e-4, atol=1e-4),
       "bfloat16": dict(rtol=2e-2, atol=5e-2)}


def _cfgs(dtype, **kw):
    jcfg = dataclasses.replace(jconfigs.smoke_config(ARCH),
                               dtype=getattr(jnp, dtype), **kw)
    tcfg = dataclasses.replace(tconfigs.smoke_config(ARCH),
                               dtype=getattr(torch, dtype), **kw)
    return jcfg, tcfg


def _moe_from_numpy(tree, cfg):
    """The reference's `moe_params` tree as the port's `MoE` module, every
    parameter trainable."""
    module = tmoe.MoE(None, cfg, device="meta")
    dtypes = {n: p.dtype for n, p in module.named_parameters()}
    state = {n: torch.from_numpy(np.array(a, dtype=np.float32)).to(dtypes[n])
             for n, a in tmodel._flatten(tree)}
    module.load_state_dict(state, strict=True, assign=True)
    for p in module.parameters():
        p.requires_grad_(True)
    return module


def _reference_slots(topi, e, cap):
    """The reference's buffer positions and drop mask (moe.py:101-107)."""
    g, tl, k = topi.shape
    onehot = jax.nn.one_hot(topi, e, dtype=jnp.int32)
    flat = onehot.reshape(g, tl * k, e)
    pos = (jnp.cumsum(flat, axis=1) * flat - 1).reshape(g, tl, k, e)
    pos_tk = (pos * onehot).sum(-1)
    within = (pos_tk >= 0) & (pos_tk < cap)
    return np.asarray(within), np.asarray(jnp.clip(pos_tk, 0, cap - 1))


def _rel_l2(got, want):
    return float(np.linalg.norm(got - want) / np.linalg.norm(want))


# (dtype, tokens as batch x seq, capacity factor): 4 tokens (a decode step
# at batch 4) fill no buffer of the minimum 4 slots; at 0.5, 64 tokens' 128
# choices overflow the 8 slots of some of the 8 experts
CASES = [("float32", (4, 1), 1.25), ("float32", (4, 16), 0.5),
         ("bfloat16", (4, 1), 1.25), ("bfloat16", (4, 16), 0.5)]


@pytest.mark.parametrize("dtype,bs,cf", CASES,
                         ids=[f"{d}-t{b * s}-cf{cf}" for d, (b, s), cf in CASES])
def test_apply_moe_matches_reference(dtype, bs, cf, monkeypatch):
    jcfg, tcfg = _cfgs(dtype, capacity_factor=cf)
    tree = jax.tree.map(np.asarray,
                        jmoe.moe_params(jax.random.PRNGKey(3), jcfg))
    b, s = bs
    rng = np.random.default_rng(4)
    x = rng.standard_normal((b, s, jcfg.d_model)).astype(np.float32)
    ct = rng.standard_normal((b, s, jcfg.d_model)).astype(np.float32)
    jx = jnp.asarray(x).astype(jcfg.dtype)
    tx = torch.tensor(x).to(tcfg.dtype)

    # the reference's routing, recorded as its apply_moe runs
    seen = []
    real_top_k = jax.lax.top_k

    def top_k(gates, k):
        out = real_top_k(gates, k)
        jax.debug.callback(lambda g, i: seen.append((np.asarray(g),
                                                     np.asarray(i))),
                           gates, out[1])
        return out
    monkeypatch.setattr(jax.lax, "top_k", top_k)
    params = jax.tree.map(jnp.asarray, tree)
    jout, jvjp = jax.vjp(jax.jit(lambda p, x: jmoe.apply_moe(p, x, jcfg)),
                         params, jx)
    jgp, jgx = jvjp(jnp.asarray(ct).astype(jout.dtype))
    (gates, jtopi), = seen

    k, e = tcfg.moe_top_k, tcfg.n_experts
    ordered = np.sort(gates, -1)[..., ::-1]
    assert (ordered[..., k - 1] - ordered[..., k]).min() > 1e-5

    module = _moe_from_numpy(tree, tcfg)
    tx.requires_grad_(True)
    g = tmoe._dp_groups(b * s)
    cap = tmoe._capacity(b * s // g, tcfg)
    _, topi = tmoe.route(module, tx.reshape(g, -1, tcfg.d_model), tcfg)
    np.testing.assert_array_equal(topi.numpy(), jtopi)
    _, within, pos_c = tmoe.dispatch_slots(topi, e, cap)
    jwithin, jpos = _reference_slots(jnp.asarray(jtopi), e, cap)
    np.testing.assert_array_equal(within.numpy(), jwithin)
    np.testing.assert_array_equal(pos_c.numpy(), jpos)
    assert bool(within.all()) == (cf > 1)      # the 0.5 cases drop tokens

    out = tmoe.apply_moe(module, tx, tcfg)
    out.backward(torch.tensor(ct).to(out.dtype))
    np.testing.assert_allclose(out.detach().float().numpy(),
                               np.asarray(jout.astype(jnp.float32)),
                               **TOL[dtype])
    want = {n: np.asarray(a, dtype=np.float32)
            for n, a in tmodel._flatten(jax.tree.map(np.asarray, jgp))}
    want["x"] = np.asarray(jgx, dtype=np.float32)
    got = {n: p.grad.float().numpy() for n, p in module.named_parameters()}
    got["x"] = tx.grad.float().numpy()
    assert set(got) == set(want)
    for name in got:
        if dtype == "float32":
            np.testing.assert_allclose(got[name], want[name], err_msg=name,
                                       **TOL[dtype])
        else:
            assert _rel_l2(got[name], want[name]) <= 2e-2, name


def test_ties_go_to_the_lower_expert_index():
    """Two router columns equal, and larger than the rest for every token:
    their gates tie exactly, and both frameworks take the lower index first
    (`torch.topk` leaves the order of equal values unspecified)."""
    _, tcfg = _cfgs("float32")
    module = tmoe.MoE(torch.Generator().manual_seed(0), tcfg, device="cpu")
    x = torch.randn((1, 6, tcfg.d_model), generator=torch.Generator()
                    .manual_seed(1)).abs()
    with torch.no_grad():
        module.router.abs_()
        module.router[:, 5] = module.router[:, 3] = module.router.max() + 1
    topv, topi = tmoe.route(module, x, tcfg)
    gates = torch.softmax(x @ module.router, dim=-1).numpy()
    assert (gates[..., 3] == gates[..., 5]).all()
    _, jtopi = jax.lax.top_k(jnp.asarray(gates), tcfg.moe_top_k)
    np.testing.assert_array_equal(topi.numpy(), np.asarray(jtopi))
    assert (topi[..., 0] == 3).all() and (topi[..., 1] == 5).all()


@pytest.mark.parametrize("tokens", [1, 4, 64, 512, 1024, 1536, 4096, 6144])
@pytest.mark.parametrize("dp", [1, 2, 4])
def test_dispatch_geometry_matches_planner_and_reference(tokens, dp):
    jcfg, tcfg = _cfgs("bfloat16")
    full = tconfigs.get_config(ARCH)
    tctx.set_mesh(HostMesh(device=torch.device("cpu"),
                           shape={"data": dp, "model": 1}))
    try:
        for cfg in (tcfg, full):
            g = tmoe._dp_groups(tokens)
            assert moe_dispatch_geometry(tokens, cfg, dp=dp) == (
                g, tmoe._capacity(tokens // g, cfg))
    finally:
        tctx.set_mesh(None)
    if dp == 1:     # the reference's, with no mesh installed
        assert tmoe._dp_groups(tokens) == jmoe._dp_groups(tokens)
        assert tmoe._capacity(tokens, tcfg) == jmoe._capacity(tokens, jcfg)


def test_params_from_numpy_carries_the_moe_tree():
    jcfg, tcfg = _cfgs("bfloat16")
    tree = jax.tree.map(np.asarray, jmodel.init_params(jax.random.PRNGKey(0),
                                                       jcfg))
    model = tmodel.params_from_numpy(tree, tcfg, device="cpu")
    params = dict(model.named_parameters())
    assert tcfg.param_count() == jcfg.param_count() == sum(
        p.numel() for p in params.values())
    moe = tree["moe_layers"]["moe"]
    for i in range(tcfg.n_layers - tcfg.n_dense_layers):
        pre = f"moe_layers.{i}.moe."
        for name, leaf in (("router", moe["router"]),
                           ("experts.gate", moe["experts"]["gate"]),
                           ("experts.down", moe["experts"]["down"]),
                           ("shared.up", moe["shared"]["up"])):
            np.testing.assert_array_equal(
                params[pre + name].float().numpy(),
                np.asarray(leaf[i], dtype=np.float32))
        assert params[pre + "router"].dtype == torch.float32
        assert params[pre + "experts.up"].dtype == torch.bfloat16
    np.testing.assert_array_equal(
        params["dense_layers.0.mlp.gate"].float().numpy(),
        np.asarray(tree["dense_layers"]["mlp"]["gate"][0], dtype=np.float32))
    assert all(not p.requires_grad for p in params.values())


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_routed_smoke_model_matches_reference(dtype, tmp_path, capsys):
    jcfg, tcfg = _cfgs(dtype)
    jparams = jmodel.init_params(jax.random.PRNGKey(0), jcfg)
    tparams = tmodel.params_from_numpy(jax.tree.map(np.asarray, jparams),
                                       tcfg, device="cpu")
    prompts = np.random.default_rng(0).integers(0, jcfg.vocab, (2, 4))
    jl, jt, jstats, jprov = _decode_jax(jcfg, jparams, prompts, 4,
                                        str(tmp_path / "j"))
    tl, tt, tstats, tprov = _decode_torch(tcfg, tparams, prompts, 4,
                                          str(tmp_path / "t"))
    np.testing.assert_allclose(tl, jl, **TOL[dtype])
    np.testing.assert_array_equal(tt, jt)

    def keys(observed):
        return {(tag, tuple(dataclasses.astuple(s))) for tag, s in observed}
    assert keys(tstats.observed) == keys(jstats.observed)
    tags = {tag for tag, _ in tstats.observed}
    assert {"moe.router", "moe.expert_gate", "moe.expert_down",
            "moe.shared_gate", "moe.shared_up", "moe.shared_down",
            "mlp.gate"} <= tags
    assert _decisions(tprov) == _decisions(jprov)
    assert tstats.resolve_rate == jstats.resolve_rate == 1.0
    assert tstats.silent_degrades == 0
    # per step: attention q/k/v/o in 3 layers, the dense MLP, the router and
    # the shared experts in 2 MoE layers, lm_head
    per_step = 4 * 3 + 3 + 4 * 2 + 1
    assert tstats.executed_gemm == (prompts.shape[1] + 4) * per_step

    toks = np.random.default_rng(2).integers(0, jcfg.vocab, (2, 8))
    want = np.asarray(jmodel.forward(jparams, jnp.asarray(toks), jcfg))
    with torch.inference_mode():
        got = tmodel.forward(tparams, torch.from_numpy(toks).long(), tcfg)
    np.testing.assert_allclose(got.numpy(), want, **TOL[dtype])
    capsys.readouterr()


def test_serve_main_serves_the_moe_smoke_model_on_cpu(tmp_path, capsys):
    """The launcher's own path: plan warm-up over `model_workload` (the MoE
    tags included), routed decode, and a run report whose workload
    cross-validation covers every observed GEMM, the recorded expert
    einsums among them, with nothing predicted left unexecuted."""
    import json
    from repro_torch.launch import serve as tserve
    from repro_torch.obs import set_tracer as tset_tracer
    report = tmp_path / "report.json"
    tserve.main(["--arch", ARCH, "--smoke", "--device", "cpu", "--batch", "4",
                 "--prompt-len", "4", "--gen", "4", "--plan-cache",
                 str(tmp_path / "plans"), "--run-report", str(report)])
    tctx.set_gemm_context(None)
    tset_tracer(None)
    assert "plan-resolve-rate=100%" in capsys.readouterr().out
    data = json.loads(report.read_text())
    assert data["routing"]["resolve_rate"] == 1.0
    assert data["routing"]["silent_degrades"] == 0
    assert data["workload"]["covered"] == 1.0
    assert data["workload"]["extra"] == data["workload"]["missing"] == []
