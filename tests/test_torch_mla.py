"""Parity of the port's MLA (DeepSeek-V2 multi-head latent attention) and of
the deepseek-v2-236b model with the JAX reference.

Both packages get the same numpy-seeded inputs and the reference's
parameters carried into the port. Tolerances: fp32 at rtol = atol = 1e-4
(the K-scaled summation-order tolerance of ROADMAP.md queue 3); bf16 at
the zoo's rtol 2e-2, atol 5e-2 (each GEMM output and each einsum rounds to
bf16, 2^-8 relative, at other points in the two frameworks).

- `mla_attention` in its naive form (no cache: K and V up-projected,
  attention at dn + dr), output and the grads of x and of every weight
  (fp32), and past 1024 tokens, where the unfused form is `chunked_sdpa`;
  in its absorbed form (cache: the query absorbs W_uk, an MQA over the
  latent cache, W_uv un-absorbs), a 4-token prefill chunk then single
  decode steps, each output and the cache's contents after them; with and
  without `q_lora_rank`.
- `params_from_numpy` carries the MLA tree under the reference's names.
- The routed smoke model decodes as the reference does (logits, greedy
  tokens exactly, the observed (tag, shape) keys with the `mla.*` ones,
  each key's plan decision, resolve rate 1.0) and its forward agrees. Its
  MoE layers run the port's own `route`, and its expert choices are held
  to the reference's, recorded as its decode routes them: at fp32 they
  must be equal. At bf16 the router's inputs are bf16 activations rounded
  at other points, which can move a near-tied gate across its neighbour:
  at most one token-layer of the run may choose otherwise, its gate
  margin must be within 1 bf16 ulp (printed; 0.025 on these weights), and
  that row alone takes the reference's choice.
- `serve.main` serves the smoke model on the CPU with a run report whose
  workload cross-validation holds.
- The port's two forms compute one function: at fp32 the naive forward's
  logits equal the absorbed decode's, position by position, within 1e-4
  (the MoE capacity raised so the batched forward drops no token, as a
  decode step at this batch cannot).
- `chip_smoke.py`'s deepseek-v2-236b phase rehearsed at smoke width on the
  CPU (the profiled parts stubbed: they trace the card).

The reference mesh uses Auto axis types (see tests/test_torch_gemm.py).
"""
import dataclasses
import json

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro import configs as jconfigs  # noqa: E402
from repro.models import attention as jattn  # noqa: E402
from repro.models import model as jmodel  # noqa: E402
from repro_torch import configs as tconfigs  # noqa: E402
from repro_torch.models import attention as tattn  # noqa: E402
from repro_torch.models import model as tmodel  # noqa: E402
from repro_torch.models import moe as tmoe  # noqa: E402
from repro_torch.models import shard_ctx as tctx  # noqa: E402
from test_torch_serve import (ROOT, _decisions, _decode_jax,  # noqa: E402
                              _decode_torch)

_real_route = tmoe.route

ARCH = "deepseek-v2-236b"
TOL = {"float32": dict(rtol=1e-4, atol=1e-4),
       "bfloat16": dict(rtol=2e-2, atol=5e-2)}


def _cfgs(dtype, **kw):
    jcfg = dataclasses.replace(jconfigs.smoke_config(ARCH),
                               dtype=getattr(jnp, dtype), **kw)
    tcfg = dataclasses.replace(tconfigs.smoke_config(ARCH),
                               dtype=getattr(torch, dtype), **kw)
    return jcfg, tcfg


def _mla_from_numpy(tree, cfg):
    """The reference's `mla_params` tree as the port's `MLA` module."""
    module = tattn.MLA(None, cfg, device="meta")
    dtypes = {n: p.dtype for n, p in module.named_parameters()}
    state = {n: torch.tensor(np.asarray(a, dtype=np.float32)).to(dtypes[n])
             for n, a in tree.items()}
    module.load_state_dict(state, strict=True, assign=True)
    return module


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(x, dtype=np.float32)


def _setup(dtype, q_lora, seed=0):
    kw = {} if q_lora else {"q_lora_rank": 0}
    jcfg, tcfg = _cfgs(dtype, **kw)
    tree = jax.tree.map(np.asarray,
                        jattn.mla_params(jax.random.PRNGKey(seed), jcfg))
    assert ("w_dq" in tree) == q_lora and ("wq" in tree) != q_lora
    return jcfg, tcfg, tree, _mla_from_numpy(tree, tcfg)


CASES = [(d, q) for d in ("float32", "bfloat16") for q in (True, False)]
IDS = [f"{d}-{'q_lora' if q else 'wq'}" for d, q in CASES]


@pytest.mark.parametrize("dtype,q_lora", CASES, ids=IDS)
def test_naive_form_matches_reference(dtype, q_lora):
    """No cache (train and prefill): output, and at fp32 the grads of x and
    of every weight through a random cotangent."""
    jcfg, tcfg, tree, module = _setup(dtype, q_lora)
    rng = np.random.default_rng(1)
    b, s = 2, 16
    x = rng.standard_normal((b, s, jcfg.d_model)).astype(np.float32)
    ct = rng.standard_normal((b, s, jcfg.d_model)).astype(np.float32)
    pos = np.arange(s)
    params = jax.tree.map(jnp.asarray, tree)
    jx = jnp.asarray(x).astype(jcfg.dtype)

    def jfn(p, xx):
        return jattn.mla_attention(p, xx, jcfg, jnp.asarray(pos))[0]

    jout, jvjp = jax.vjp(jax.jit(jfn), params, jx)
    for p in module.parameters():
        p.requires_grad_(True)
    tx = torch.tensor(x).to(tcfg.dtype).requires_grad_(True)
    out, cache = tattn.mla_attention(module, tx, tcfg, torch.arange(s))
    assert cache is None
    np.testing.assert_allclose(_np(out), _np(jout.astype(jnp.float32)),
                               **TOL[dtype])
    if dtype != "float32":
        return
    jgp, jgx = jvjp(jnp.asarray(ct))
    out.backward(torch.tensor(ct))
    np.testing.assert_allclose(_np(tx.grad), _np(jgx), **TOL[dtype])
    for name, p in module.named_parameters():
        np.testing.assert_allclose(_np(p.grad), _np(jgp[name]), err_msg=name,
                                   **TOL[dtype])


def test_naive_form_past_1024_tokens_takes_chunked_sdpa(monkeypatch):
    """At 1040 tokens the unfused attention is `chunked_sdpa` in both (the
    port's recorded at d = dn + dr, dv = dn), fp32."""
    jcfg, tcfg, tree, module = _setup("float32", True)
    s = 1040
    x = np.random.default_rng(2).standard_normal(
        (1, s, jcfg.d_model)).astype(np.float32)
    jout = jax.jit(lambda p, xx: jattn.mla_attention(
        p, xx, jcfg, jnp.arange(s))[0])(jax.tree.map(jnp.asarray, tree),
                                        jnp.asarray(x))
    seen = []
    real = tattn.chunked_sdpa

    def chunked(q, k, v, **kw):
        seen.append((q.shape[-1], v.shape[-1]))
        return real(q, k, v, **kw)
    monkeypatch.setattr(tattn, "chunked_sdpa", chunked)
    with torch.no_grad():
        out, _ = tattn.mla_attention(module, torch.tensor(x), tcfg,
                                     torch.arange(s))
    dn, dr = tcfg.nope_head_dim, tcfg.rope_head_dim
    assert seen == [(dn + dr, dn)]
    np.testing.assert_allclose(_np(out), _np(jout), **TOL["float32"])


@pytest.mark.parametrize("dtype,q_lora", CASES, ids=IDS)
def test_absorbed_form_and_its_cache_match_reference(dtype, q_lora):
    """With a cache (decode): a 4-token prefill chunk, then 4 single-token
    steps, each output against the reference's, and the cache's latent and
    rotary key after the prefill and at the end."""
    jcfg, tcfg, tree, module = _setup(dtype, q_lora)
    b, prefill, steps = 2, 4, 4
    max_len = prefill + steps
    x = np.random.default_rng(3).standard_normal(
        (b, max_len, jcfg.d_model)).astype(np.float32)
    params = jax.tree.map(jnp.asarray, tree)
    jstep = jax.jit(lambda p, xx, pos, c: jattn.mla_attention(
        p, xx, jcfg, pos, c))
    jcache = jattn.make_kv_cache(jcfg, b, max_len)
    tcache = tattn.make_kv_cache(tcfg, b, max_len, device="cpu")
    assert set(tcache) == set(jcache) == {"c_kv", "k_rope", "index"}
    assert tcache["k_rope"].shape == jcache["k_rope"].shape == (
        b, max_len, 1, tcfg.rope_head_dim)
    chunks = [(0, prefill)] + [(i, i + 1) for i in range(prefill, max_len)]
    for lo, hi in chunks:
        jout, jcache = jstep(params, jnp.asarray(x[:, lo:hi]).astype(
            jcfg.dtype), jnp.arange(lo, hi), jcache)
        with torch.inference_mode():
            tout, tcache = tattn.mla_attention(
                module, torch.tensor(x[:, lo:hi]).to(tcfg.dtype), tcfg,
                torch.arange(lo, hi), tcache)
        np.testing.assert_allclose(_np(tout), _np(jout.astype(jnp.float32)),
                                   err_msg=f"positions {lo}-{hi}",
                                   **TOL[dtype])
        assert tcache["index"] == int(jcache["index"]) == hi
        if hi == prefill or hi == max_len:
            for key in ("c_kv", "k_rope"):
                np.testing.assert_allclose(
                    _np(tcache[key]), _np(jcache[key].astype(jnp.float32)),
                    err_msg=key, **TOL[dtype])


def test_params_from_numpy_carries_the_mla_tree():
    jcfg, tcfg = _cfgs("bfloat16")
    tree = jax.tree.map(np.asarray, jmodel.init_params(jax.random.PRNGKey(0),
                                                       jcfg))
    model = tmodel.params_from_numpy(tree, tcfg, device="cpu")
    params = dict(model.named_parameters())
    assert tcfg.param_count() == jcfg.param_count() == sum(
        p.numel() for p in params.values())
    names = ("w_dkv", "w_kr", "w_uk", "w_uv", "wo", "w_dq", "w_uq")
    for group, n in (("dense_layers", tcfg.n_dense_layers),
                     ("moe_layers", tcfg.n_layers - tcfg.n_dense_layers)):
        attn = tree[group]["attn"]
        assert set(attn) == set(names)
        for i in range(n):
            for name in names:
                np.testing.assert_array_equal(
                    _np(params[f"{group}.{i}.attn.{name}"]),
                    np.asarray(attn[name][i], dtype=np.float32))
    assert all(p.dtype == torch.bfloat16 for n, p in params.items()
               if ".attn." in n)
    assert all(not p.requires_grad for p in params.values())


def _bf16_ulps(a: torch.Tensor, b: torch.Tensor) -> float:
    """a - b (fp32, a >= b > 0) in units of a's bf16 ulp: 8 significant
    bits, so an ulp is 2^(floor(log2 a) - 7)."""
    return float((a - b) / torch.exp2(torch.floor(torch.log2(a)) - 7))


def _route_held(monkeypatch, choices, fp32, flips):
    """Run the port's own `route` on every MoE call and hold its expert
    choices (descending, as `jax.lax.top_k` orders them) to the
    reference's (`choices`, call by call). At fp32 they must be equal and
    nothing is replaced. At bf16 a token-layer that chose otherwise takes
    the reference's row, with the port's own gates (those its `route`
    computed) renormalised over it; `flips` gets, for each such row, the
    gate margin at the first place the two orders part: the port's gate of
    its own pick less its gate of the reference's, in bf16 ulps."""
    queue = list(choices)
    logits = []
    real_pmm = tmoe.pmm

    def pmm(x, w, tag=""):
        out = real_pmm(x, w, tag=tag)
        if tag == "moe.router":
            logits.append(out)
        return out

    def route(p, xt, c):
        topv, topi = _real_route(p, xt, c)
        gates = torch.softmax(logits.pop(), dim=-1)
        want = torch.from_numpy(queue.pop(0)).long()
        assert want.shape == topi.shape
        if fp32:
            np.testing.assert_array_equal(topi.numpy(), want.numpy())
            return topv, topi
        topv, topi = topv.clone(), topi.clone()
        for row in (topi != want).any(-1).nonzero().tolist():
            row = tuple(row)
            own, ref, g = topi[row], want[row], gates[row]
            j = int((own != ref).nonzero()[0])
            flips.append(_bf16_ulps(g[own[j]], g[ref[j]]))
            v = g[ref]
            topv[row], topi[row] = v / torch.clamp(v.sum(), min=1e-9), ref
        return topv, topi
    monkeypatch.setattr(tmoe, "pmm", pmm)
    monkeypatch.setattr(tmoe, "route", route)
    return queue


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_routed_smoke_model_matches_reference(dtype, tmp_path, capsys,
                                              monkeypatch):
    """Routed decode (the absorbed form) and the unrouted forward (the naive
    form) of the whole smoke model: 1 dense + 2 MoE layers of MLA."""
    jcfg, tcfg = _cfgs(dtype)
    jparams = jmodel.init_params(jax.random.PRNGKey(0), jcfg)
    tparams = tmodel.params_from_numpy(jax.tree.map(np.asarray, jparams),
                                       tcfg, device="cpu")
    prompts = np.random.default_rng(0).integers(0, jcfg.vocab, (2, 4))
    seen = []
    real_top_k = jax.lax.top_k

    def top_k(gates, k):
        out = real_top_k(gates, k)
        jax.debug.callback(lambda i: seen.append(np.array(i)), out[1],
                           ordered=True)
        return out
    monkeypatch.setattr(jax.lax, "top_k", top_k)
    jl, jt, jstats, jprov = _decode_jax(jcfg, jparams, prompts, 4,
                                        str(tmp_path / "j"))
    monkeypatch.setattr(jax.lax, "top_k", real_top_k)
    moe_layers = tcfg.n_layers - tcfg.n_dense_layers
    assert len(seen) == (prompts.shape[1] + 4) * moe_layers
    flips = []
    left = _route_held(monkeypatch, seen, dtype == "float32", flips)
    tl, tt, tstats, tprov = _decode_torch(tcfg, tparams, prompts, 4,
                                          str(tmp_path / "t"))
    monkeypatch.undo()
    rows = sum(c.size // c.shape[-1] for c in seen)
    with capsys.disabled():
        print(f"\n{dtype}: {len(flips)} of {rows} token-layers chose "
              f"otherwise, gate margins {flips} bf16 ulps")
    assert not left and len(flips) <= 1
    assert all(0 <= m <= 1 for m in flips), flips
    assert tl.shape == jl.shape == (8, 2, tcfg.vocab)
    np.testing.assert_allclose(tl, jl, **TOL[dtype])
    np.testing.assert_array_equal(tt, jt)

    def keys(observed):
        return {(tag, tuple(dataclasses.astuple(s))) for tag, s in observed}
    assert keys(tstats.observed) == keys(jstats.observed)
    tags = {tag for tag, _ in tstats.observed}
    assert {"mla.q_down", "mla.q_up", "mla.kv_down", "mla.k_rope",
            "mla.q_absorb", "mla.v_unabsorb", "mla.o", "moe.router"} <= tags
    assert _decisions(tprov) == _decisions(jprov)
    assert tstats.resolve_rate == jstats.resolve_rate == 1.0
    assert tstats.silent_degrades == 0
    # per step: 5 MLA projections in 3 layers, the dense MLP, the router
    # and the shared experts in 2 MoE layers, lm_head
    per_step = 5 * 3 + 3 + 4 * 2 + 1
    assert tstats.executed_gemm == (prompts.shape[1] + 4) * per_step

    toks = np.random.default_rng(2).integers(0, jcfg.vocab, (2, 8))
    want = np.asarray(jmodel.forward(jparams, jnp.asarray(toks), jcfg))
    with torch.inference_mode():
        got = tmodel.forward(tparams, torch.from_numpy(toks).long(), tcfg)
    np.testing.assert_allclose(got.numpy(), want, **TOL[dtype])
    capsys.readouterr()


def test_serve_main_serves_the_mla_smoke_model_on_cpu(tmp_path, capsys):
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


def test_naive_and_absorbed_forms_compute_one_function():
    """fp32: the batched forward (naive form) against the same tokens
    decoded one at a time (absorbed form), every position. The capacity is
    raised so the forward's dispatch drops no token, as none can drop in a
    decode step at batch 2 (2 tokens, at least 4 slots)."""
    _, tcfg = _cfgs("float32")
    cfg = dataclasses.replace(tcfg, capacity_factor=tcfg.n_experts
                              / tcfg.moe_top_k + 1e-6)
    b, s = 2, 12
    assert tmoe._capacity(b * s, cfg) >= b * s
    params = tmodel.init_params(torch.Generator().manual_seed(0), cfg, "cpu")
    toks = torch.from_numpy(np.random.default_rng(4).integers(
        0, cfg.vocab, (b, s))).long()
    with torch.inference_mode():
        naive = tmodel.forward(params, toks, cfg)
        caches = tmodel.decode_init(params, cfg, b, s)
        absorbed = []
        for i in range(s):
            logits, caches = tmodel.decode_step(params, caches,
                                                toks[:, i:i + 1], i, cfg)
            absorbed.append(logits)
    np.testing.assert_allclose(torch.stack(absorbed, 1).numpy(),
                               naive.numpy(), rtol=1e-4, atol=1e-4)


def test_chip_smoke_v2_phase_rehearsed_on_cpu(monkeypatch, tmp_path, capsys):
    """`chip_smoke.serve_model` with `naive_vs_absorbed` on the smoke model
    and CPU tensors: the launch census (the wrapper counts none on the CPU,
    so a counting wrapper stands in), resolve rate, the workload check, and
    the naive form's logits against the absorbed decode's with the decode's
    expert choices pinned, and the naive forward's launch table (its
    shapes are held to the plain version on the card; here the table must
    add up to the forward's launches). The device profiles are stubbed."""
    import importlib
    monkeypatch.syspath_prepend(str(ROOT))
    chip_smoke = importlib.import_module("chip_smoke")
    mmad_mod = importlib.import_module("repro_torch.kernels.mmad")
    from repro_torch.kernels import ops
    real = ops.mmad

    def counted(a, b, *args, **kw):
        mmad_mod._launches += 1
        return real(a, b, *args, **kw)
    monkeypatch.setattr(ops, "mmad", counted)
    stub = {"busy_ms": 1, "wall_ms": 1, "mmad_ms": 0, "moe_einsums_ms": 0}
    monkeypatch.setattr(chip_smoke, "busy_share", lambda *a, **k: stub)
    monkeypatch.setattr(chip_smoke, "step_split", lambda *a, **k: stub)
    held = []
    monkeypatch.setattr(chip_smoke, "hold_shapes",
                        lambda *a, **k: held.append(a[4]) or 0.0)
    monkeypatch.setattr(chip_smoke, "ROOT", tmp_path)
    cfg, dev = tconfigs.smoke_config(ARCH), torch.device("cpu")
    launches, per_step, summary = chip_smoke.serve_model(
        torch, mmad_mod, cfg, dev,
        after=lambda p, planner, prompts: chip_smoke.naive_vs_absorbed(
            torch, mmad_mod, cfg, dev, p, planner, prompts))
    steps = chip_smoke.PROMPT + chip_smoke.GEN
    assert launches == steps * (5 * 3 + 3 + 4 * 2 + 1)
    assert sum(r["count"] for r in per_step.values()) * steps == launches
    assert summary["naive_absorbed_rel_l2"] <= chip_smoke.NAIVE_ABSORBED_REL_L2
    assert summary["naive_launches"] > 0
    assert len(held) == 1 and summary["naive_shapes"] == len(held[0])
    assert sum(r["count"] for r in held[0].values()) == \
        summary["naive_launches"]
    assert any(k[3] == "torch.float32" for k in held[0])   # the router
    assert summary["same_input_flips"] == 0
    capsys.readouterr()
