"""The port's recurrent stacks (zamba2's Mamba2, xLSTM's mLSTM and sLSTM)
against the JAX reference's.

- Mixers, at smoke widths, the reference's parameters carried across and
  numpy inputs from a seed: `_causal_conv` with and without state,
  `_ssd_chunked`, and `mamba2_mixer`, `mlstm_mixer` and `slstm_mixer` in
  both forms (chunked / parallel without state, recurrent with it; the
  final states too); the port's chunked forms against its own recurrent
  forms at seq 256 (two chunks), and sLSTM's state carried across a split
  sequence. fp32 at rtol = atol = 1e-4; bf16 at the serve parity bounds
  of tests/test_torch_serve.py (rtol 2e-2, atol 5e-2).
- Models: the routed smoke decode of zamba2-1.2b (5 layers: two
  super-layers of two Mamba2 blocks and the shared attention block, then
  a one-block tail) and xlstm-1.3b (two super-layers of one mLSTM and one
  sLSTM block) against the reference's (`_decode_jax`, Auto axis types):
  logits within those bounds with equal greedy tokens, the same (tag,
  shape) keys and routing decisions, resolve rate 1.0, and the dispatch
  counts per step (2 n_mamba + 7 n_super + 1 GEMMs and n_super
  attentions; 6 n_mlstm + 2 n_slstm + 1 GEMMs). The unrouted forward,
  the carried parameter tree (zamba2's unstacked `shared_attn` included),
  `serve.main` on the CPU, and a CPU rehearsal of `chip_smoke.py`'s two
  serve phases.
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
from repro.models import model as jmodel  # noqa: E402
from repro.models import ssm as jssm  # noqa: E402
from repro_torch import configs as tconfigs  # noqa: E402
from repro_torch.models import model as tmodel  # noqa: E402
from repro_torch.models import ssm as tssm  # noqa: E402
from test_torch_serve import (_decisions, _decode_jax,  # noqa: E402
                              _decode_torch)

ROOT = pathlib.Path(__file__).resolve().parents[1]
ZAMBA, XLSTM = "zamba2-1.2b", "xlstm-1.3b"
TOL = {"float32": dict(rtol=1e-4, atol=1e-4),
       "bfloat16": dict(rtol=2e-2, atol=5e-2)}
DTYPES = ["float32", "bfloat16"]
SEQ = 2 * tssm.CHUNK


def _cfgs(arch, dtype):
    return (dataclasses.replace(jconfigs.smoke_config(arch),
                                dtype=getattr(jnp, dtype)),
            dataclasses.replace(tconfigs.smoke_config(arch),
                                dtype=getattr(torch, dtype)))


def _np(x):
    return np.asarray(x.detach().float() if isinstance(x, torch.Tensor)
                      else jnp.asarray(x, jnp.float32))


def _t(a, dtype=torch.float32):
    return torch.from_numpy(np.array(a, dtype=np.float32)).to(dtype)


def _carry(module, tree):
    """The reference's parameter dict (jax arrays) into a meta-built
    module of the port, at the module's own dtypes."""
    dtypes = {name: p.dtype for name, p in module.named_parameters()}
    module.load_state_dict({k: _t(v, dtypes[k]) for k, v in tree.items()},
                           strict=True, assign=True)
    return module


def _x(s, d, seed=0, batch=2):
    return np.random.default_rng(seed).standard_normal((batch, s, d)) * 0.1


def _close(got, want, dtype, **kw):
    np.testing.assert_allclose(_np(got), _np(want), **TOL[dtype], **kw)


# ---------------------------------------------------------------------------
# Mamba2
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("with_state", [False, True])
@pytest.mark.parametrize("dtype", DTYPES)
def test_causal_conv_matches_reference(dtype, with_state):
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    rng = np.random.default_rng(1)
    x = rng.standard_normal((2, 5, 24))
    w = rng.standard_normal((4, 24)) * 0.1
    st = rng.standard_normal((2, 3, 24)) if with_state else None
    jy, jst = jssm._causal_conv(jnp.asarray(x, jdt), jnp.asarray(w, jdt),
                                None if st is None else jnp.asarray(st, jdt))
    ty, tst = tssm._causal_conv(_t(x, tdt), _t(w, tdt),
                                None if st is None else _t(st, tdt))
    assert ty.dtype == tdt and tst.shape == (2, 3, 24)
    _close(ty, jy, dtype)
    _close(tst, jst, dtype)


@pytest.mark.parametrize("with_h0", [False, True])
def test_ssd_chunked_matches_reference(with_h0):
    rng = np.random.default_rng(2)
    b, s, h, p, n = 2, SEQ, 4, 8, 16
    xh = rng.standard_normal((b, s, h, p))
    dt = np.log1p(np.exp(rng.standard_normal((b, s, h))))
    a = -np.exp(rng.standard_normal(h) * 0.5)
    bm, cm = rng.standard_normal((b, s, n)), rng.standard_normal((b, s, n))
    h0 = rng.standard_normal((b, h, n, p)) if with_h0 else None
    jy, jh = jssm._ssd_chunked(*(jnp.asarray(v, jnp.float32)
                                 for v in (xh, dt, a, bm, cm)),
                               None if h0 is None else jnp.asarray(h0))
    ty, th = tssm._ssd_chunked(*(_t(v) for v in (xh, dt, a, bm, cm)),
                               None if h0 is None else _t(h0))
    assert ty.shape == (b, s, h, p) and th.shape == (b, h, n, p)
    _close(ty, jy, "float32")
    _close(th, jh, "float32")


def _mixer_pair(kind, arch, dtype, seed):
    jcfg, tcfg = _cfgs(arch, dtype)
    jp = getattr(jssm, f"{kind}_params")(jax.random.PRNGKey(seed), jcfg)
    tp = _carry(getattr(tssm, f"{kind}_params")(None, tcfg, "meta"), jp)
    return jcfg, tcfg, jp, tp


def _state_pair(kind, jcfg, tcfg, batch, rng):
    """The reference's fresh state and the port's, both moved off zero by
    the same draws (the stabilisers `m` kept finite)."""
    jst = getattr(jssm, f"{kind}_state")(jcfg, batch)
    draws = {k: rng.standard_normal(v.shape) * (0.1 if k != "m" else 1.0)
             for k, v in jst.items()}
    jst = {k: jnp.asarray(v, jst[k].dtype) for k, v in draws.items()}
    tst = getattr(tssm, f"{kind}_state")(tcfg, batch, "cpu")
    tst = {k: _t(v, tst[k].dtype) for k, v in draws.items()}
    return jst, tst


MIXERS = [("mamba2", ZAMBA), ("mlstm", XLSTM), ("slstm", XLSTM)]


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("kind,arch", MIXERS, ids=[k for k, _ in MIXERS])
def test_mixer_chunked_form_matches_reference(kind, arch, dtype):
    """Without state: Mamba2's SSD and mLSTM's stabilised parallel form
    over two chunks, sLSTM's scan from its zero state."""
    jcfg, tcfg, jp, tp = _mixer_pair(kind, arch, dtype, 3)
    x = _x(SEQ, jcfg.d_model, seed=4)
    jy, jst = getattr(jssm, f"{kind}_mixer")(
        jp, jnp.asarray(x, jnp.float32).astype(jcfg.dtype), jcfg)
    with torch.inference_mode():
        ty, tst = getattr(tssm, f"{kind}_mixer")(tp, _t(x, tcfg.dtype), tcfg)
    assert jst is None and tst is None
    assert ty.dtype == tcfg.dtype and ty.shape == (2, SEQ, tcfg.d_model)
    _close(ty, jy, dtype)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("kind,arch", MIXERS, ids=[k for k, _ in MIXERS])
def test_mixer_recurrent_form_matches_reference(kind, arch, dtype):
    """With state: the recurrent steps from a state off zero, outputs and
    every final state leaf."""
    jcfg, tcfg, jp, tp = _mixer_pair(kind, arch, dtype, 5)
    jst, tst = _state_pair(kind, jcfg, tcfg, 2, np.random.default_rng(6))
    x = _x(6, jcfg.d_model, seed=7)
    jy, jnew = getattr(jssm, f"{kind}_mixer")(
        jp, jnp.asarray(x, jnp.float32).astype(jcfg.dtype), jcfg, jst)
    with torch.inference_mode():
        ty, tnew = getattr(tssm, f"{kind}_mixer")(tp, _t(x, tcfg.dtype),
                                                  tcfg, tst)
    _close(ty, jy, dtype)
    assert set(tnew) == set(jnew)
    for key in jnew:
        assert tnew[key].dtype == tst[key].dtype
        _close(tnew[key], jnew[key], dtype, err_msg=key)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("kind,arch", MIXERS[:2], ids=["mamba2", "mlstm"])
def test_port_chunked_form_equals_its_recurrent_form(kind, arch, dtype):
    """The port's own two forms at seq 256 (two chunks), from the zero
    state (tests/test_attention_ssm.py holds the reference's the same
    way)."""
    _, tcfg, _, tp = _mixer_pair(kind, arch, dtype, 8)
    x = _x(SEQ, tcfg.d_model, seed=9)
    mixer = getattr(tssm, f"{kind}_mixer")
    with torch.inference_mode():
        xt = _t(x, tcfg.dtype)
        y_par, _ = mixer(tp, xt, tcfg)
        y_rec, _ = mixer(tp, xt, tcfg,
                         getattr(tssm, f"{kind}_state")(tcfg, 2, "cpu"))
    _close(y_par, y_rec, dtype)


def test_recurrent_steps_update_the_large_states_in_place():
    """Mamba2's `h` and mLSTM's `c` and `n` are written in place; the
    returned state shares them."""
    for kind, arch in MIXERS[:2]:
        _, tcfg, _, tp = _mixer_pair(kind, arch, "float32", 10)
        st = getattr(tssm, f"{kind}_state")(tcfg, 2, "cpu")
        big = {"mamba2": ("h",), "mlstm": ("c", "n")}[kind]
        ptrs = {k: st[k].data_ptr() for k in big}
        x = _x(1, tcfg.d_model, seed=11)
        with torch.inference_mode():
            _, new = getattr(tssm, f"{kind}_mixer")(tp, _t(x), tcfg, st)
        for k in big:
            assert new[k].data_ptr() == ptrs[k]
            assert bool(new[k].abs().sum() > 0)


@pytest.mark.parametrize("dtype", DTYPES)
def test_slstm_state_continuity(dtype):
    """Running sLSTM over [a; b] equals running over a, then b from the
    carried state."""
    _, tcfg, _, tp = _mixer_pair("slstm", XLSTM, dtype, 12)
    x = _x(32, tcfg.d_model, seed=13, batch=1)
    xt = _t(x, tcfg.dtype)
    with torch.inference_mode():
        y_full, _ = tssm.slstm_mixer(tp, xt, tcfg,
                                     tssm.slstm_state(tcfg, 1, "cpu"))
        y1, st = tssm.slstm_mixer(tp, xt[:, :16], tcfg,
                                  tssm.slstm_state(tcfg, 1, "cpu"))
        y2, _ = tssm.slstm_mixer(tp, xt[:, 16:], tcfg, st)
    np.testing.assert_array_equal(_np(torch.cat([y1, y2], 1)), _np(y_full))


# ---------------------------------------------------------------------------
# models
# ---------------------------------------------------------------------------

def _per_step(tcfg):
    """(routed GEMMs, attention calls) of one decode step."""
    if tcfg.block_pattern == "mamba2_hybrid":
        n_super = tcfg.n_layers // tcfg.hybrid_attn_every
        return 2 * tcfg.n_layers + 7 * n_super + 1, n_super
    n_slstm = tcfg.n_layers // tcfg.slstm_every
    return 6 * (tcfg.n_layers - n_slstm) + 2 * n_slstm + 1, 0


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("arch", [ZAMBA, XLSTM])
def test_routed_smoke_decode_matches_reference(arch, dtype, tmp_path, capsys):
    jcfg, tcfg = _cfgs(arch, dtype)
    jparams = jmodel.init_params(jax.random.PRNGKey(0), jcfg)
    tparams = tmodel.params_from_numpy(jax.tree.map(np.asarray, jparams),
                                       tcfg, device="cpu")
    assert tcfg.param_count() == jcfg.param_count()
    prompts = np.random.default_rng(0).integers(0, jcfg.vocab, (2, 4))
    jl, jt, jstats, jprov = _decode_jax(jcfg, jparams, prompts, 4,
                                        str(tmp_path / "j"))
    tl, tt, tstats, tprov = _decode_torch(tcfg, tparams, prompts, 4,
                                          str(tmp_path / "t"))
    assert tl.shape == jl.shape == (8, 2, tcfg.vocab)
    np.testing.assert_allclose(tl, jl, **TOL[dtype])
    np.testing.assert_array_equal(tt, jt)
    assert np.isfinite(tl).all()

    def keys(observed):
        return {(tag, tuple(dataclasses.astuple(s))) for tag, s in observed}
    assert keys(tstats.observed) == keys(jstats.observed)
    assert keys(tstats.attn_observed) == keys(jstats.attn_observed)
    assert set(tstats.modes) == set(jstats.modes)
    assert _decisions(tprov) == _decisions(jprov)
    assert tstats.resolve_rate == jstats.resolve_rate == 1.0
    assert tstats.silent_degrades == jstats.silent_degrades == 0
    gemms, attns = _per_step(tcfg)
    steps = prompts.shape[1] + 4
    assert tstats.executed_gemm == steps * gemms
    assert tstats.executed_attn == steps * attns


# fp32 over two chunks; bf16 at the 8 tokens the zoo's forward tests take.
# Over 256 tokens the bf16 logits of every ported stack hold the bounds but
# at a few of 131,072 elements (zamba2 6, xlstm 4; gemma-2b 7, qwen3-14b
# 15, up to 0.10 from the reference's): fp32 sums in another order flip
# bf16 roundings, which travel; the mixers' bf16 tests hold two chunks.
FORWARDS = [("float32", SEQ), ("bfloat16", 8)]


@pytest.mark.parametrize("dtype,seq", FORWARDS,
                         ids=[d for d, _ in FORWARDS])
@pytest.mark.parametrize("arch", [ZAMBA, XLSTM])
def test_unrouted_forward_matches_reference(arch, dtype, seq):
    """`forward` without a context: the chunked SSD and mLSTM forms (over
    two chunks in fp32), the shared block at the full positions."""
    jcfg, tcfg = _cfgs(arch, dtype)
    jparams = jmodel.init_params(jax.random.PRNGKey(1), jcfg)
    tparams = tmodel.params_from_numpy(jax.tree.map(np.asarray, jparams),
                                       tcfg, device="cpu")
    toks = np.random.default_rng(2).integers(0, jcfg.vocab, (2, seq))
    want = np.asarray(jmodel.forward(jparams, jnp.asarray(toks), jcfg))
    with torch.inference_mode():
        got = tmodel.forward(tparams, torch.from_numpy(toks).long(), tcfg)
    np.testing.assert_allclose(got.numpy(), want, **TOL[dtype])


@pytest.mark.parametrize("arch", [ZAMBA, XLSTM])
def test_params_from_numpy_carries_the_recurrent_trees(arch):
    jcfg, tcfg = _cfgs(arch, "bfloat16")
    tree = jax.tree.map(np.asarray, jmodel.init_params(jax.random.PRNGKey(0),
                                                       jcfg))
    model = tmodel.params_from_numpy(tree, tcfg, device="cpu")
    params = dict(model.named_parameters())
    assert tcfg.param_count() == jcfg.param_count() == sum(
        p.numel() for p in params.values())
    stacked = {ZAMBA: ("mamba_layers", "mamba_tail"),
               XLSTM: ("mlstm_layers", "slstm_layers")}[arch]
    seen = 0
    for group in stacked:
        for path, leaf in tmodel._flatten(tree[group]):
            for i in range(len(leaf)):
                np.testing.assert_array_equal(
                    _np(params[f"{group}.{i}.{path}"]),
                    np.asarray(leaf[i], dtype=np.float32))
                seen += 1
    if arch == ZAMBA:
        # ONE shared block: its leaves carry no layer index
        for path, leaf in tmodel._flatten(tree["shared_attn"]):
            np.testing.assert_array_equal(
                _np(params[f"shared_attn.{path}"]),
                np.asarray(leaf, dtype=np.float32))
            seen += 1
        assert not any(n.startswith("shared_attn.0.") for n in params)
    assert seen + 2 == len(params)                 # + embed, ln_f.scale
    fp32 = {"a_log", "d_skip", "dt_bias", "w_gates", "r"}
    for name, p in params.items():
        leaf = name.rsplit(".", 1)[-1]
        want = (torch.float32 if leaf in fp32 or leaf == "scale"
                else torch.bfloat16)
        assert p.dtype == want, name
        assert not p.requires_grad


@pytest.mark.parametrize("arch", [ZAMBA, XLSTM])
def test_serve_main_serves_the_recurrent_smoke_models_on_cpu(arch, tmp_path,
                                                             capsys):
    from repro_torch.launch import serve as tserve
    from repro_torch.models import shard_ctx as tctx
    from repro_torch.obs import set_tracer as tset_tracer
    report = tmp_path / "report.json"
    tserve.main(["--arch", arch, "--smoke", "--device", "cpu", "--batch",
                 "2", "--prompt-len", "4", "--gen", "4", "--plan-cache",
                 str(tmp_path / "plans"), "--run-report", str(report)])
    tctx.set_gemm_context(None)
    tset_tracer(None)
    out = capsys.readouterr().out
    assert "plan-resolve-rate=100%" in out
    rep = json.loads(report.read_text())
    routing = rep["routing"]
    assert routing["resolve_rate"] == 1.0 and routing["silent_degrades"] == 0
    gemms, attns = _per_step(tconfigs.smoke_config(arch))
    assert routing["executed"]["gemm"] == 8 * gemms
    assert routing["executed"]["attn"] == 8 * attns
    workload = rep["workload"]
    assert workload["covered"] == 1.0
    assert workload["extra"] == [] and workload["missing"] == []


@pytest.mark.parametrize("arch", [ZAMBA, XLSTM])
def test_chip_smoke_ssm_phase_rehearsed_on_cpu(arch, monkeypatch, tmp_path,
                                               capsys):
    """`chip_smoke.serve_model` with `chunked_vs_recurrent` on the smoke
    model and CPU tensors: the launch census (the wrapper counts none on
    the CPU, so a counting wrapper stands in), resolve rate, the workload
    check, the launch table per step, and the chunked forward of 2 x 256
    tokens held to the recurrent decode of the same tokens; its launch
    table adds up to its launches and carries the fp32 gates (its shapes
    are held to the plain version on the card). The device profiles are
    stubbed."""
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
    cfg, dev = tconfigs.smoke_config(arch), torch.device("cpu")
    spans = chip_smoke.state_spans(cfg)
    assert spans == ({"mamba.state": 5} if arch == ZAMBA
                     else {"mlstm.state": 2, "slstm.state": 2})
    monkeypatch.setattr(chip_smoke, "busy_share", lambda *a, **k: {
        "busy_ms": 1, "wall_ms": 1, "mmad_ms": 0})
    monkeypatch.setattr(chip_smoke, "step_split", lambda *a, **k: {
        "step_busy_ms": 1, "step_mmad_ms": 0,
        **{chip_smoke.span_key(n): 0 for n in spans}})
    held = []
    monkeypatch.setattr(chip_smoke, "hold_shapes",
                        lambda *a, **k: held.append(a[4]) or 0.0)
    monkeypatch.setattr(chip_smoke, "ROOT", tmp_path)
    launches, per_step, summary = chip_smoke.serve_model(
        torch, mmad_mod, cfg, dev,
        after=lambda p, planner, prompts: chip_smoke.chunked_vs_recurrent(
            torch, mmad_mod, cfg, dev, p, planner))
    steps = chip_smoke.PROMPT + chip_smoke.GEN
    gemms, _ = _per_step(cfg)
    assert launches == steps * gemms
    assert sum(r["count"] for r in per_step.values()) == gemms
    assert (summary["chunked_recurrent_rel_l2"]
            <= chip_smoke.CHUNKED_RECURRENT_REL_L2)
    assert summary["chunked_launches"] == gemms
    assert len(held) == 1 and summary["chunked_shapes"] == len(held[0])
    assert sum(r["count"] for r in held[0].values()) == gemms
    assert all(k[0] == chip_smoke.CHECK_BATCH * chip_smoke.CHECK_SEQ
               for k in held[0])
    fp32 = [k for k in held[0] if k[3] == "torch.float32"]
    assert fp32 == ([(512, 2 * cfg.n_heads, cfg.d_model, "torch.float32")]
                    if arch == XLSTM else [])
    capsys.readouterr()
