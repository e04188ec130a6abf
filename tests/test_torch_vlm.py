"""The port's VLM (phi-3-vision-4.2b: a phi3-mini backbone, MHA, behind a
stub CLIP frontend) against the JAX reference's, at smoke width (3
layers, d_model 64, 16 patch embeddings), the reference's parameters
carried across with `params_from_numpy` and inputs from numpy seeds.

- Attention at head dim 96 (the full model's, the first not a power of
  two): `gqa_attention` with RoPE, causal, routed and unrouted, fp32 at
  rtol = atol = 1e-4 and bf16 at the serve parity bounds (rtol 2e-2,
  atol 5e-2); `rope_tables` at 96.
- `forward` with `prefix_embeds`, routed and unrouted, fp32 and bf16: the
  patch embeddings through `frontend.proj` and prepended (logits over
  prefix plus tokens), and routed the same observed keys.
- 8 routed decode steps (text only, as the reference's launcher serves
  it) against the reference's decode under an Auto-axis mesh.
- `params_from_numpy` carries `frontend_proj`; `loss_and_grads` against
  `jax.value_and_grad` of the reference's `loss_fn`, which drops the
  prefix positions before the loss; `serve.main --arch phi-3-vision-4.2b
  --smoke --device cpu`.
- A CPU rehearsal of `chip_smoke.py`'s phi-3-vision phase (`serve_model`
  with `prefix_forward`).
"""
import dataclasses
import json
import pathlib

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro.launch import serve as jserve  # noqa: E402
from repro.models import attention as jattn  # noqa: E402
from repro.models import common as jcommon  # noqa: E402
from repro.models import model as jmodel  # noqa: E402
from repro.models import shard_ctx as jctx  # noqa: E402
from repro_torch import configs as tconfigs  # noqa: E402
from repro_torch.launch import mesh as tmesh  # noqa: E402
from repro_torch.launch import serve as tserve  # noqa: E402
from repro_torch.models import attention as tattn  # noqa: E402
from repro_torch.models import common as tcommon  # noqa: E402
from repro_torch.models import model as tmodel  # noqa: E402
from repro_torch.models import shard_ctx as tctx  # noqa: E402
from repro_torch.obs import set_tracer as tset_tracer  # noqa: E402
from test_torch_encdec import (DTYPES, ROUTED, TOL, _cfgs,  # noqa: E402
                               _frames, _keys, _models, _named,
                               check_loss_and_grads)
from test_torch_serve import (_decisions, _decode_jax,  # noqa: E402
                              _decode_torch, _forward_jax, _forward_torch,
                              _jax_mesh)

ROOT = pathlib.Path(__file__).resolve().parents[1]
ARCH = "phi-3-vision-4.2b"


def test_full_config_has_head_dim_96():
    cfg = tconfigs.get_config(ARCH)
    assert (cfg.hd, cfg.n_heads, cfg.n_kv_heads) == (96, 32, 32)
    assert cfg.frontend == "vision_stub" and cfg.n_prefix == 576


@pytest.mark.parametrize("routed", ROUTED, ids=["unrouted", "routed"])
@pytest.mark.parametrize("dtype", DTYPES)
def test_attention_at_head_dim_96_matches_reference(dtype, routed, tmp_path,
                                                    capsys):
    """Self-attention with RoPE at phi-3-vision's head dim, 2 heads of 96:
    `rope_tables` halves it into 48 frequencies, `_sdpa` and the routed
    `pattn` take it unchanged."""
    jcfg, tcfg = (dataclasses.replace(c, d_model=192, n_heads=2,
                                      n_kv_heads=2)
                  for c in _cfgs(ARCH, dtype))
    assert tcfg.hd == jcfg.hd == 96
    pos = np.arange(3, 11)
    cos, sin = tcommon.rope_tables(torch.from_numpy(pos), 96, tcfg.rope_theta)
    jcos, jsin = jcommon.rope_tables(jnp.asarray(pos), 96, jcfg.rope_theta)
    assert tuple(cos.shape) == (8, 48)
    np.testing.assert_allclose(cos.numpy(), np.asarray(jcos), atol=1e-6)
    np.testing.assert_allclose(sin.numpy(), np.asarray(jsin), atol=1e-6)
    jp = jattn.gqa_params(jax.random.PRNGKey(4), jcfg)
    tp = tattn.gqa_params(None, tcfg, device="meta")
    tp.load_state_dict({k: torch.from_numpy(np.asarray(v, np.float32))
                        .to(tcfg.dtype) for k, v in jp.items()}, assign=True)
    x = np.random.default_rng(5).standard_normal((2, 8, 192))

    def jrun():
        return np.asarray(jax.jit(lambda xx, pp: jattn.gqa_attention(
            jp, xx, jcfg, pp)[0])(jnp.asarray(x, jcfg.dtype),
                                  jnp.asarray(pos)), np.float32)

    def trun():
        with torch.inference_mode():
            return tattn.gqa_attention(
                tp, torch.from_numpy(x).to(tcfg.dtype), tcfg,
                torch.from_numpy(pos))[0].float().numpy()

    if not routed:
        want, got = jrun(), trun()
    else:
        jplanner = jserve.warm_plan_cache(jcfg, 2, 8, 8, str(tmp_path / "j"),
                                          (4, 4), 12)
        tplanner = tserve.warm_plan_cache(tcfg, 2, 8, 8, str(tmp_path / "t"),
                                          (4, 4), 12)
        jc = jctx.GemmContext(mesh=_jax_mesh(), planner=jplanner)
        tc = tctx.GemmContext(mesh=tmesh.make_host_mesh("cpu"),
                              planner=tplanner)
        with jctx.gemm_context(jc):
            want = jrun()
        with tctx.gemm_context(tc):
            got = trun()
        assert _keys(tc.stats.attn_observed) == _keys(jc.stats.attn_observed)
        (_, shape), = tc.stats.attn_observed
        assert (shape.d, shape.h, shape.causal) == (96, 2, True)
        assert tc.stats.resolve_rate == jc.stats.resolve_rate == 1.0
        assert tc.stats.executed_attn == 1
    np.testing.assert_allclose(got, want, **TOL[dtype])
    capsys.readouterr()


@pytest.mark.parametrize("routed", ROUTED, ids=["unrouted", "routed"])
@pytest.mark.parametrize("dtype", DTYPES)
def test_forward_with_prefix_embeds_matches_reference(dtype, routed,
                                                      tmp_path, capsys):
    jcfg, tcfg, jparams, tparams = _models(ARCH, dtype, seed=1)
    toks = np.random.default_rng(2).integers(0, jcfg.vocab, (2, 8))
    patches = _frames(jcfg, 7)
    want, jstats = _forward_jax(jcfg, jparams, toks, str(tmp_path / "j"),
                                routed, prefix_embeds=patches)
    got, tstats = _forward_torch(tcfg, tparams, toks, str(tmp_path / "t"),
                                 routed, prefix_embeds=patches)
    rows = tcfg.n_prefix + 8
    assert got.shape == want.shape == (2, rows, tcfg.vocab)
    np.testing.assert_allclose(got, want, **TOL[dtype])
    if routed:
        assert _keys(tstats.observed) == _keys(jstats.observed)
        assert _keys(tstats.attn_observed) == _keys(jstats.attn_observed)
        d = tcfg.d_model
        assert {("frontend.proj", (2 * tcfg.n_prefix, d, d)),
                ("lm_head", (2 * rows, tcfg.vocab, d))} <= _keys(
                    tstats.observed)
        assert tstats.resolve_rate == jstats.resolve_rate == 1.0
        assert tstats.silent_degrades == 0
        assert tstats.executed_gemm == 1 + 7 * tcfg.n_layers + 1
    capsys.readouterr()


@pytest.mark.parametrize("dtype", DTYPES)
def test_routed_decode_matches_reference(dtype, tmp_path, capsys):
    jcfg, tcfg, jparams, tparams = _models(ARCH, dtype)
    assert tcfg.param_count() == jcfg.param_count()
    prompts = np.random.default_rng(0).integers(0, jcfg.vocab, (2, 4))
    jl, jt, jstats, jprov = _decode_jax(jcfg, jparams, prompts, 4,
                                        str(tmp_path / "j"))
    tl, tt, tstats, tprov = _decode_torch(tcfg, tparams, prompts, 4,
                                          str(tmp_path / "t"))
    np.testing.assert_allclose(tl, jl, **TOL[dtype])
    np.testing.assert_array_equal(tt, jt)
    assert _keys(tstats.observed) == _keys(jstats.observed)
    assert _decisions(tprov) == _decisions(jprov)
    assert tstats.resolve_rate == jstats.resolve_rate == 1.0
    assert tstats.executed_gemm == 8 * (7 * tcfg.n_layers + 1)
    assert "frontend.proj" not in {tag for tag, _ in tstats.observed}
    capsys.readouterr()


def test_params_from_numpy_carries_frontend_proj():
    jcfg, tcfg = _cfgs(ARCH, "bfloat16")
    tree = jax.tree.map(np.asarray, jmodel.init_params(jax.random.PRNGKey(0),
                                                       jcfg))
    model = tmodel.params_from_numpy(tree, tcfg, device="cpu")
    params = dict(model.named_parameters())
    want = _named(tree)
    assert set(params) == set(want) and "frontend_proj" in params
    for name, p in params.items():
        np.testing.assert_array_equal(p.float().numpy(),
                                      np.asarray(want[name], np.float32))
    assert tuple(params["frontend_proj"].shape) == (tcfg.d_model,) * 2


@pytest.mark.parametrize("dtype", DTYPES)
def test_loss_and_grads_match_reference(dtype):
    check_loss_and_grads(ARCH, dtype, "prefix_embeds")


def test_serve_main_serves_phi3_vision_on_cpu(tmp_path, capsys):
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
    assert routing["executed"]["gemm"] == 8 * (7 * cfg.n_layers + 1)
    assert workload["covered"] == 1.0
    assert workload["extra"] == [] and workload["missing"] == []


def test_chip_smoke_vlm_phase_rehearsed_on_cpu(monkeypatch, tmp_path,
                                               capsys):
    """`chip_smoke.serve_model` with `prefix_forward` on the smoke model and
    CPU tensors: the decode's launch census (a counting wrapper stands in
    for the kernel's count), resolve rate and workload; then the routed
    forward of the patch embeddings and the prompt against the unrouted
    one, every call held on its operands. The device profile and the
    shapes' hold on the card are stubbed."""
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
        after=lambda p, planner, prompts: chip_smoke.prefix_forward(
            torch, mmad_mod, cfg, dev, p, planner, prompts))
    steps = chip_smoke.PROMPT + chip_smoke.GEN
    gemms = 7 * cfg.n_layers + 1
    assert launches == steps * gemms
    assert sum(r["count"] for r in per_step.values()) == gemms
    assert summary["prefix_rel_l2"] <= chip_smoke.PREFIX_FORWARD_REL_L2
    assert summary["prefix_launches"] == gemms + 1     # + frontend.proj
    rows = chip_smoke.BATCH * (cfg.n_prefix + chip_smoke.PROMPT)
    assert len(held) == 1
    assert held[0] is summary["forward_table"]
    assert sum(r["count"] for r in held[0].values()) == gemms + 1
    assert {(chip_smoke.BATCH * cfg.n_prefix, cfg.d_model, cfg.d_model,
             "torch.bfloat16"),
            (rows, cfg.vocab, cfg.d_model, "torch.bfloat16")} <= set(held[0])
    capsys.readouterr()
