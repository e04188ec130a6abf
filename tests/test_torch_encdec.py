"""The port's encoder-decoder (seamless-m4t-medium) against the JAX
reference's, at smoke width (2 encoder + 2 decoder layers, d_model 64, 24
frames), the reference's parameters carried across with
`params_from_numpy` and inputs from numpy seeds.

- Cross-attention alone (`gqa_attention` with `kv_input`): not causal, no
  RoPE (its output does not move with the query positions), K and V at
  the encoder's rows; `cache` and `kv_input` together raise. Routed and
  unrouted, fp32 at rtol = atol = 1e-4 and bf16 at the serve parity
  bounds (rtol 2e-2, atol 5e-2); routed, the same observed (tag, shape)
  keys as the reference's, `attn.k` / `attn.v` at the encoder's rows and
  `attn.sdpa` over the frames.
- `forward` with `encoder_embeds`, routed and unrouted, fp32 and bf16:
  the logits, and routed the same observed keys and one dispatch per
  GEMM the forward runs.
- 8 routed decode steps (prompt 4 + gen 4) attending to one encoder
  output, against the reference's decode under an Auto-axis mesh
  (`_decode_jax`): logits, greedy tokens, keys, decisions, resolve rate.
- `params_from_numpy` carries `frontend_proj`, `encoder.*`, `decoder.*`
  (with `ln_x` and `xattn`) and `ln_enc`.
- `loss_and_grads` against `jax.value_and_grad` of the reference's
  `loss_fn` on a batch with `encoder_embeds`: fp32 at rtol = atol = 1e-4,
  bf16 at the serve parity bounds.
- `serve.main --arch seamless-m4t-medium --smoke --device cpu`: resolve
  rate 1.0 and a run report whose observed workload is `model_workload`'s.
- `input_specs` for every arch x `SHAPES` entry: the reference's keys,
  shapes and dtypes (its stacked caches as the port's per-layer lists).
- A CPU rehearsal of `chip_smoke.py`'s seamless phase (`serve_model` with
  `encoder_vs_decode`).
"""
import dataclasses
import json
import pathlib

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro import configs as jconfigs  # noqa: E402
from repro.launch import input_specs as jspecs  # noqa: E402
from repro.models import attention as jattn  # noqa: E402
from repro.models import model as jmodel  # noqa: E402
from repro.models import shard_ctx as jctx  # noqa: E402
from repro.train import steps as jsteps  # noqa: E402
from repro_torch import configs as tconfigs  # noqa: E402
from repro_torch.launch import input_specs as tspecs  # noqa: E402
from repro_torch.launch import mesh as tmesh  # noqa: E402
from repro_torch.launch import serve as tserve  # noqa: E402
from repro_torch.models import attention as tattn  # noqa: E402
from repro_torch.models import model as tmodel  # noqa: E402
from repro_torch.models import shard_ctx as tctx  # noqa: E402
from repro_torch.obs import set_tracer as tset_tracer  # noqa: E402
from repro_torch.train import steps as tsteps  # noqa: E402
from test_torch_serve import (_decisions, _decode_jax,  # noqa: E402
                              _decode_torch, _forward_jax, _forward_torch,
                              _jax_mesh)

ROOT = pathlib.Path(__file__).resolve().parents[1]
ARCH = "seamless-m4t-medium"
TOL = {"float32": dict(rtol=1e-4, atol=1e-4),
       "bfloat16": dict(rtol=2e-2, atol=5e-2)}
DTYPES = ["float32", "bfloat16"]
ROUTED = [False, True]


def _cfgs(arch, dtype):
    return (dataclasses.replace(jconfigs.smoke_config(arch),
                                dtype=getattr(jnp, dtype)),
            dataclasses.replace(tconfigs.smoke_config(arch),
                                dtype=getattr(torch, dtype)))


def _models(arch, dtype, seed=0):
    jcfg, tcfg = _cfgs(arch, dtype)
    jparams = jmodel.init_params(jax.random.PRNGKey(seed), jcfg)
    tparams = tmodel.params_from_numpy(jax.tree.map(np.asarray, jparams),
                                       tcfg, device="cpu")
    return jcfg, tcfg, jparams, tparams


def _frames(cfg, seed, batch=2):
    return np.random.default_rng(seed).standard_normal(
        (batch, cfg.n_prefix, cfg.d_model)).astype(np.float32)


def _keys(observed):
    return {(tag, tuple(dataclasses.astuple(s))) for tag, s in observed}


def _named(tree):
    """The reference's parameter-shaped pytree under the port's names:
    block i of a stacked group G at `G.i.<path>`."""
    out = {}
    for name, leaf in tmodel._flatten(tree):
        group, _, rest = name.partition(".")
        if group in tmodel._STACKED:
            for i in range(len(leaf)):
                out[f"{group}.{i}.{rest}"] = leaf[i]
        else:
            out[name] = leaf
    return out


def check_loss_and_grads(arch, dtype, extras_key):
    """`loss_and_grads` of a smoke model on a batch with the frontend input
    `extras_key` against `jax.value_and_grad` of the reference's
    `loss_fn`: fp32 at rtol = atol = 1e-4, bf16 at TOL."""
    jcfg, tcfg, jparams, tparams = _models(arch, dtype)
    tmodel.make_trainable(tparams)
    rng = np.random.default_rng(3)
    toks = rng.integers(0, jcfg.vocab, (2, 9))
    extra = rng.standard_normal((2, jcfg.n_prefix, jcfg.d_model)) * 0.5
    jb = {"tokens": jnp.asarray(toks[:, :-1], jnp.int32),
          "targets": jnp.asarray(toks[:, 1:], jnp.int32),
          extras_key: jnp.asarray(extra, jcfg.dtype)}
    tb = {"tokens": torch.from_numpy(toks[:, :-1]),
          "targets": torch.from_numpy(toks[:, 1:]),
          extras_key: torch.from_numpy(np.asarray(jb[extras_key],
                                                  np.float32)).to(tcfg.dtype)}
    jloss, jgrads = jax.jit(jax.value_and_grad(
        lambda p: jsteps.loss_fn(p, jb, jcfg)))(jparams)
    tloss, tgrads = tsteps.loss_and_grads(tparams, tb, tcfg)
    tol = TOL[dtype]
    np.testing.assert_allclose(float(tloss), float(jloss), **tol)
    want = _named(jax.tree.map(lambda g: np.asarray(g, np.float32), jgrads))
    assert set(tgrads) == set(want)
    for name, g in tgrads.items():
        assert g.dtype == dict(tparams.named_parameters())[name].dtype, name
        np.testing.assert_allclose(g.float().numpy(), want[name],
                                   err_msg=name, **tol)
    assert any(np.abs(want[n]).max() > 0 for n in want
               if n.startswith("frontend_proj"))


# ---------------------------------------------------------------------------
# cross-attention
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("routed", ROUTED, ids=["unrouted", "routed"])
@pytest.mark.parametrize("dtype", DTYPES)
def test_cross_attention_matches_reference(dtype, routed, tmp_path, capsys):
    jcfg, tcfg = _cfgs(ARCH, dtype)
    jp = jattn.gqa_params(jax.random.PRNGKey(4), jcfg)
    tp = tattn.gqa_params(None, tcfg, device="meta")
    tp.load_state_dict({k: torch.from_numpy(np.asarray(v, np.float32))
                        .to(tcfg.dtype) for k, v in jp.items()}, assign=True)
    rng = np.random.default_rng(5)
    x = rng.standard_normal((2, 8, jcfg.d_model)).astype(np.float32)
    kv = _frames(jcfg, 6)
    pos = np.arange(8)

    def jrun(positions):
        return np.asarray(jax.jit(lambda xx, kk, pp: jattn.gqa_attention(
            jp, xx, jcfg, pp, causal=False, kv_input=kk)[0])(
            jnp.asarray(x, jcfg.dtype), jnp.asarray(kv, jcfg.dtype),
            jnp.asarray(positions)), np.float32)

    def trun(positions):
        with torch.inference_mode():
            out, cache = tattn.gqa_attention(
                tp, torch.from_numpy(x).to(tcfg.dtype), tcfg,
                torch.from_numpy(positions), causal=False,
                kv_input=torch.from_numpy(kv).to(tcfg.dtype))
        assert cache is None
        return out.float().numpy()

    jctx_ = tctx_ = None
    if routed:
        jplanner = tserve_planner = None
        from repro.launch import serve as jserve
        jplanner = jserve.warm_plan_cache(jcfg, 2, 8, 8, str(tmp_path / "j"),
                                          (4, 4), 12)
        tserve_planner = tserve.warm_plan_cache(tcfg, 2, 8, 8,
                                                str(tmp_path / "t"), (4, 4),
                                                12)
        jctx_ = jctx.GemmContext(mesh=_jax_mesh(), planner=jplanner)
        tctx_ = tctx.GemmContext(mesh=tmesh.make_host_mesh("cpu"),
                                 planner=tserve_planner)
        with jctx.gemm_context(jctx_):
            want = jrun(pos)
        with tctx.gemm_context(tctx_):
            got, moved = trun(pos), trun(pos + 5)
    else:
        want, got, moved = jrun(pos), trun(pos), trun(pos + 5)
    np.testing.assert_allclose(got, want, **TOL[dtype])
    np.testing.assert_array_equal(moved, got)      # no RoPE on either side
    if routed:
        assert _keys(tctx_.stats.observed) == _keys(jctx_.stats.observed)
        assert _keys(tctx_.stats.attn_observed) == _keys(
            jctx_.stats.attn_observed)
        d, rows = tcfg.d_model, 2 * tcfg.n_prefix
        hd = tcfg.n_kv_heads * tcfg.hd
        assert {(t, s) for t, s in _keys(tctx_.stats.observed)} == {
            ("attn.q", (16, tcfg.n_heads * tcfg.hd, d)),
            ("attn.k", (rows, hd, d)), ("attn.v", (rows, hd, d)),
            ("attn.o", (16, d, tcfg.n_heads * tcfg.hd))}
        (tag, shape), = tctx_.stats.attn_observed
        assert tag == "attn.sdpa"
        assert (shape.sq, shape.skv, shape.causal) == (8, tcfg.n_prefix,
                                                       False)
        assert tctx_.stats.resolve_rate == 1.0
        assert tctx_.stats.executed_gemm == 2 * 4
    capsys.readouterr()


def test_cross_attention_takes_no_cache():
    cfg = tconfigs.smoke_config(ARCH)
    p = tattn.gqa_params(torch.Generator().manual_seed(0), cfg, device="cpu")
    x = torch.zeros((1, 1, cfg.d_model), dtype=cfg.dtype)
    cache = tattn.make_kv_cache(cfg, 1, 4, device="cpu")
    with pytest.raises(ValueError, match="mutually exclusive"):
        tattn.gqa_attention(p, x, cfg, torch.arange(1), cache, kv_input=x)


# ---------------------------------------------------------------------------
# the model
# ---------------------------------------------------------------------------

def _forward_gemms(cfg) -> int:
    """Routed GEMM dispatches of one encoder-decoder forward: frontend.proj,
    each encoder layer's q, k, v, o and MLP, each decoder layer's self and
    cross q, k, v, o and MLP, lm_head."""
    return 1 + 7 * cfg.n_encoder_layers + 11 * cfg.n_layers + 1


@pytest.mark.parametrize("routed", ROUTED, ids=["unrouted", "routed"])
@pytest.mark.parametrize("dtype", DTYPES)
def test_forward_with_encoder_embeds_matches_reference(dtype, routed,
                                                       tmp_path, capsys):
    jcfg, tcfg, jparams, tparams = _models(ARCH, dtype, seed=1)
    toks = np.random.default_rng(2).integers(0, jcfg.vocab, (2, 8))
    frames = _frames(jcfg, 7)
    want, jstats = _forward_jax(jcfg, jparams, toks, str(tmp_path / "j"),
                                routed, encoder_embeds=frames)
    got, tstats = _forward_torch(tcfg, tparams, toks, str(tmp_path / "t"),
                                 routed, encoder_embeds=frames)
    assert got.shape == want.shape == (2, 8, tcfg.vocab)
    np.testing.assert_allclose(got, want, **TOL[dtype])
    if routed:
        assert _keys(tstats.observed) == _keys(jstats.observed)
        assert _keys(tstats.attn_observed) == _keys(jstats.attn_observed)
        assert ("frontend.proj", (2 * tcfg.n_prefix, tcfg.d_model,
                                  tcfg.d_model)) in _keys(tstats.observed)
        assert tstats.resolve_rate == jstats.resolve_rate == 1.0
        assert tstats.silent_degrades == 0
        assert tstats.executed_gemm == _forward_gemms(tcfg)
        # encoder self-attention, decoder self- and cross-attention
        assert tstats.executed_attn == (tcfg.n_encoder_layers
                                        + 2 * tcfg.n_layers)
    capsys.readouterr()


def test_forward_needs_encoder_embeds():
    cfg = tconfigs.smoke_config(ARCH)
    params = tmodel.init_params(torch.Generator().manual_seed(0), cfg, "cpu")
    toks = torch.zeros((1, 4), dtype=torch.long)
    with pytest.raises(ValueError, match="encoder_embeds"):
        tmodel.forward(params, toks, cfg)
    caches = tmodel.decode_init(params, cfg, 1, 4)
    with pytest.raises(ValueError, match="encoder_out"):
        tmodel.decode_step(params, caches, toks[:, :1], 0, cfg)


@pytest.mark.parametrize("dtype", DTYPES)
def test_routed_decode_matches_reference(dtype, tmp_path, capsys):
    jcfg, tcfg, jparams, tparams = _models(ARCH, dtype)
    assert tcfg.param_count() == jcfg.param_count()
    prompts = np.random.default_rng(0).integers(0, jcfg.vocab, (2, 4))
    enc = _frames(jcfg, 8)
    jl, jt, jstats, jprov = _decode_jax(jcfg, jparams, prompts, 4,
                                        str(tmp_path / "j"), encoder_out=enc)
    tl, tt, tstats, tprov = _decode_torch(tcfg, tparams, prompts, 4,
                                          str(tmp_path / "t"),
                                          encoder_out=enc)
    assert tl.shape == jl.shape == (8, 2, tcfg.vocab)
    np.testing.assert_allclose(tl, jl, **TOL[dtype])
    np.testing.assert_array_equal(tt, jt)
    assert _keys(tstats.observed) == _keys(jstats.observed)
    assert _keys(tstats.attn_observed) == _keys(jstats.attn_observed)
    assert _decisions(tprov) == _decisions(jprov)
    assert tstats.resolve_rate == jstats.resolve_rate == 1.0
    assert tstats.silent_degrades == 0
    # per step: self and cross q, k, v, o and the MLP in every decoder
    # layer (cross K / V at the encoder's rows), lm_head
    steps = prompts.shape[1] + 4
    assert tstats.executed_gemm == steps * (11 * tcfg.n_layers + 1)
    assert tstats.executed_attn == steps * 2 * tcfg.n_layers
    capsys.readouterr()


def test_params_from_numpy_carries_the_encdec_tree():
    jcfg, tcfg = _cfgs(ARCH, "bfloat16")
    tree = jax.tree.map(np.asarray, jmodel.init_params(jax.random.PRNGKey(0),
                                                       jcfg))
    assert {"encoder", "decoder", "ln_enc", "frontend_proj"} <= set(tree)
    model = tmodel.params_from_numpy(tree, tcfg, device="cpu")
    params = dict(model.named_parameters())
    want = _named(tree)
    assert set(params) == set(want)
    for name, p in params.items():
        np.testing.assert_array_equal(p.float().numpy(),
                                      np.asarray(want[name], np.float32))
        assert p.dtype == (torch.float32 if name.endswith("scale")
                           else torch.bfloat16), name
        assert not p.requires_grad
    assert "decoder.1.xattn.wk" in params and "decoder.0.ln_x.scale" in params
    assert not any(".xattn." in n for n in params if n.startswith("encoder"))


@pytest.mark.parametrize("dtype", DTYPES)
def test_loss_and_grads_match_reference(dtype):
    check_loss_and_grads(ARCH, dtype, "encoder_embeds")


def test_serve_main_serves_seamless_on_cpu(tmp_path, capsys):
    report = tmp_path / "report.json"
    tserve.main(["--arch", ARCH, "--smoke", "--device", "cpu", "--batch",
                 "2", "--prompt-len", "4", "--gen", "4", "--plan-cache",
                 str(tmp_path / "plans"), "--run-report", str(report)])
    tctx.set_gemm_context(None)
    tset_tracer(None)
    assert "plan-resolve-rate=100%" in capsys.readouterr().out
    rep = json.loads(report.read_text())
    routing, workload = rep["routing"], rep["workload"]
    assert routing["resolve_rate"] == 1.0 and routing["silent_degrades"] == 0
    cfg = tconfigs.smoke_config(ARCH)
    assert routing["executed"]["gemm"] == 8 * (11 * cfg.n_layers + 1)
    assert workload["covered"] == 1.0
    assert workload["extra"] == [] and workload["missing"] == []
    # the cross-attention K / V at the encoder's rows are in it
    assert [2 * cfg.n_prefix, cfg.d_model, cfg.d_model] in [
        r["shape"] for r in routing["observed"] if r["tag"] == "attn.k"]


# ---------------------------------------------------------------------------
# input_specs
# ---------------------------------------------------------------------------

def _spec_leaves(tree):
    """(path, shape, dtype name) of every array leaf of an input spec."""
    out = []

    def walk(node, path):
        if isinstance(node, dict):
            for k in sorted(node):
                walk(node[k], f"{path}.{k}")
        elif hasattr(node, "shape"):
            out.append((path, tuple(node.shape),
                        str(node.dtype).split(".")[-1]))
    walk(tree, "")
    return out


@pytest.mark.parametrize("shape", list(jconfigs.SHAPES))
@pytest.mark.parametrize("arch", jconfigs.list_archs())
def test_input_specs_match_reference(arch, shape):
    jspec = jspecs.input_specs(jconfigs.get_config(arch), shape)
    tspec = tspecs.input_specs(tconfigs.get_config(arch), shape)
    assert set(tspec) == set(jspec)
    for key in ("kind", "batch", "seq"):
        assert tspec[key] == jspec[key]
    tcaches = tspec.pop("caches", None)
    jcaches = jspec.pop("caches", None)
    assert _spec_leaves(tspec) == _spec_leaves(jspec)
    assert all(t.device.type == "meta" for t in jax.tree.leaves(
        [v for v in tspec.values() if not isinstance(v, (int, str))]))
    if jcaches is None:
        assert tcaches is None
        return
    # the reference stacks each group's caches on a leading layer axis
    assert set(tcaches) == set(jcaches)
    for group, layers in tcaches.items():
        stacked = _spec_leaves(jcaches[group])
        for path, shp, dt in _spec_leaves(layers[0]):
            if path == ".index":
                continue
            assert (path, (len(layers),) + shp, dt) in stacked, (group, path)
        assert all(_spec_leaves(c) == _spec_leaves(layers[0])
                   for c in layers)


# ---------------------------------------------------------------------------
# chip_smoke's phase, rehearsed
# ---------------------------------------------------------------------------

def test_chip_smoke_seamless_phase_rehearsed_on_cpu(monkeypatch, tmp_path,
                                                    capsys):
    """`chip_smoke.serve_model` with `encoder_vs_decode` on the smoke model
    and CPU tensors: the decode's launch census (a counting wrapper stands
    in for the kernel's count, which the CPU path leaves at zero) with the
    cross-attention K / V at the encoder's rows, resolve rate and
    workload; then the routed forward over the frames and the prompt
    against the routed decode of the prompt on that forward's encoder
    output, logits at every prompt position held. The device profile and
    the shapes' hold on the card are stubbed."""
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
    monkeypatch.setattr(chip_smoke, "busy_share", lambda *a, **k: {
        "busy_ms": 1, "wall_ms": 1, "mmad_ms": 0})
    held = []
    monkeypatch.setattr(chip_smoke, "hold_shapes",
                        lambda *a, **k: held.append(a[4]) or 0.0)
    monkeypatch.setattr(chip_smoke, "ROOT", tmp_path)
    cfg, dev = tconfigs.smoke_config(ARCH), torch.device("cpu")
    launches, per_step, summary = chip_smoke.serve_model(
        torch, mmad_mod, cfg, dev,
        after=lambda p, planner, prompts: chip_smoke.encoder_vs_decode(
            torch, mmad_mod, cfg, dev, p, planner, prompts))
    steps = chip_smoke.PROMPT + chip_smoke.GEN
    gemms = 11 * cfg.n_layers + 1
    assert launches == steps * gemms
    assert sum(r["count"] for r in per_step.values()) == gemms
    rows = chip_smoke.BATCH * cfg.n_prefix
    assert per_step[(rows, cfg.d_model, cfg.d_model, "torch.bfloat16")][
        "count"] == 2 * cfg.n_layers                # cross K and V
    assert summary["encoder_decode_rel_l2"] <= chip_smoke.ENCODER_DECODE_REL_L2
    assert summary["encoder_launches"] == _forward_gemms(cfg)
    assert len(held) == 1
    assert sum(r["count"] for r in held[0].values()) == _forward_gemms(cfg)
    assert (rows, cfg.d_model, cfg.d_model, "torch.bfloat16") in held[0]
    capsys.readouterr()
