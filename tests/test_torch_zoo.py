"""The port's model zoo against the JAX reference's.

- The dense GQA configs olmo-1b (non-parametric LayerNorm, MHA, tied),
  phi4-mini-3.8b (GQA 4/2 at smoke width, tied) and qwen3-14b (qk-norm,
  head_dim 16 at smoke width, untied lm_head): smoke-width routed decode
  and the unrouted forward from the reference's carried weights, with the
  serve parity tolerances of tests/test_torch_serve.py (fp32 rtol = atol =
  1e-4; bf16 rtol 2e-2, atol 5e-2) and equal greedy tokens, the same
  observed (tag, shape) keys and routing decisions, resolve rate 1.0.
- The registry lists exactly the reference's ten architectures, each full
  and smoke config equal field by field to the reference's, and the model
  builds every one of them (deepseek-v2-236b's MLA is held to the
  reference in tests/test_torch_mla.py, zamba2-1.2b and xlstm-1.3b in
  tests/test_torch_ssm.py, seamless-m4t-medium in
  tests/test_torch_encdec.py, phi-3-vision-4.2b in
  tests/test_torch_vlm.py).
- `apply_mlp` at bf16 for swiglu, geglu and gelu: every product's inputs
  and the gate and up products bitwise equal to the reference's (the
  activations as its bf16 op chains round them), the output within one
  bf16 ulp (the down product's fp32 sums are taken in another order).
- A CPU rehearsal of `chip_smoke.py`'s serve phases of olmo-1b and
  phi4-mini-3.8b (`serve_model` on the smoke model with CPU tensors).
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro import configs as jconfigs  # noqa: E402
from repro.models import model as jmodel  # noqa: E402
from repro_torch import configs as tconfigs  # noqa: E402
from repro_torch.models import model as tmodel  # noqa: E402
from test_torch_serve import (ROOT, _decisions, _decode_jax,  # noqa: E402
                              _decode_torch)

PORTED = ["deepseek-moe-16b", "deepseek-v2-236b", "gemma-2b", "olmo-1b",
          "phi-3-vision-4.2b", "phi4-mini-3.8b", "qwen3-14b",
          "seamless-m4t-medium", "xlstm-1.3b", "zamba2-1.2b"]
DENSE = ["olmo-1b", "phi4-mini-3.8b", "qwen3-14b"]
TOL = {"float32": dict(rtol=1e-4, atol=1e-4),
       "bfloat16": dict(rtol=2e-2, atol=5e-2)}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("arch", DENSE)
def test_dense_smoke_model_matches_reference(arch, dtype, tmp_path, capsys):
    jcfg = dataclasses.replace(jconfigs.smoke_config(arch),
                               dtype=getattr(jnp, dtype))
    tcfg = dataclasses.replace(tconfigs.smoke_config(arch),
                               dtype=getattr(torch, dtype))
    jparams = jmodel.init_params(jax.random.PRNGKey(0), jcfg)
    tparams = tmodel.params_from_numpy(jax.tree.map(np.asarray, jparams),
                                       tcfg, device="cpu")
    assert tcfg.param_count() == jcfg.param_count()
    assert (tparams.lm_head is None) == tcfg.tie_embeddings
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
    assert _decisions(tprov) == _decisions(jprov)
    assert tstats.resolve_rate == jstats.resolve_rate == 1.0
    assert tstats.executed_gemm == (prompts.shape[1] + 4) * (
        7 * tcfg.n_layers + 1)

    toks = np.random.default_rng(2).integers(0, jcfg.vocab, (2, 8))
    want = np.asarray(jmodel.forward(jparams, jnp.asarray(toks), jcfg))
    with torch.inference_mode():
        got = tmodel.forward(tparams, torch.from_numpy(toks).long(), tcfg)
    np.testing.assert_allclose(got.numpy(), want, **TOL[dtype])
    capsys.readouterr()


def _fields(cfg):
    return {k: v for k, v in dataclasses.asdict(cfg).items() if k != "dtype"}


def test_registry_lists_the_ported_architectures():
    assert tconfigs.list_archs() == PORTED
    for arch in PORTED:
        for name in (arch, f"{arch}-smoke"):
            tcfg, jcfg = tconfigs.get_config(name), jconfigs.get_config(name)
            assert _fields(tcfg) == _fields(jcfg)
            assert tcfg.dtype == torch.bfloat16


def test_registry_lists_exactly_the_reference_architectures():
    """Every architecture the reference registers is ported: the same
    list, and a model of each builds (on the meta device) with the
    reference's parameter count."""
    assert tconfigs.list_archs() == jconfigs.list_archs()
    for arch in tconfigs.list_archs():
        tcfg, jcfg = tconfigs.smoke_config(arch), jconfigs.smoke_config(arch)
        tmodel.init_params(None, tcfg, device="meta")
        assert tcfg.param_count() == jcfg.param_count()


def _recorded(module, monkeypatch):
    """Record each `pmm` call's (tag, x, x @ w) in `module`'s namespace."""
    calls = []

    def pmm(x, w, tag=""):
        out = x @ w
        calls.append((tag, x, out))
        return out
    monkeypatch.setattr(module, "pmm", pmm)
    return calls


@pytest.mark.parametrize("act,arch", [("swiglu", "phi4-mini-3.8b"),
                                      ("geglu", "gemma-2b"),
                                      ("gelu", "seamless-m4t-medium")])
def test_apply_mlp_bf16_matches_reference_bitwise(act, arch, monkeypatch):
    """`common.activation` rounds as the reference's bf16 op chains
    (`jax.nn.silu`, `jax.nn.gelu(approximate=True)`): the down product's
    input, the activation, equals the reference's bit for bit, as do the
    gate and up products; the output differs only where the down
    product's fp32 sum, taken in another order, rounds to the next bf16
    value."""
    from repro.models import common as jcommon
    from repro_torch.models import common as tcommon
    jcfg, tcfg = jconfigs.smoke_config(arch), tconfigs.smoke_config(arch)
    assert jcfg.act == tcfg.act == act
    jp = jcommon.mlp_params(jax.random.PRNGKey(0), jcfg)
    tp = tcommon.mlp_params(None, tcfg, device="meta")
    tp.load_state_dict({k: torch.from_numpy(np.asarray(v, np.float32))
                        .bfloat16() for k, v in jp.items()}, assign=True)
    x = np.random.default_rng(0).standard_normal((2, 16, jcfg.d_model))
    jcalls = _recorded(jcommon, monkeypatch)
    tcalls = _recorded(tcommon, monkeypatch)
    want = jcommon.apply_mlp(jp, jnp.asarray(x, jnp.bfloat16), jcfg)
    got = tcommon.apply_mlp(tp, torch.from_numpy(x).bfloat16(), tcfg)
    assert [c[0] for c in tcalls] == [c[0] for c in jcalls] == [
        "mlp.gate", "mlp.up", "mlp.down"]
    for (tag, tx, tout), (_, jx, jout) in zip(tcalls, jcalls):
        assert tx.dtype == tout.dtype == torch.bfloat16
        np.testing.assert_array_equal(tx.float().numpy(),
                                      np.asarray(jx, np.float32), tag)
        if tag != "mlp.down":
            np.testing.assert_array_equal(tout.float().numpy(),
                                          np.asarray(jout, np.float32), tag)
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32),
                               rtol=2.0 ** -7, atol=0)


@pytest.mark.parametrize("arch", ["olmo-1b", "phi4-mini-3.8b"])
def test_chip_smoke_dense_serve_phase_rehearsed_on_cpu(arch, monkeypatch,
                                                       tmp_path, capsys):
    """`chip_smoke.serve_model` on the smoke model with CPU tensors, as its
    card phase runs the full one: the routed first step against the
    unrouted one, then `serve.generate` with one `mmad` launch per routed
    dispatch (a counting wrapper stands in for the kernel's count), the
    observed workload equal to `model_workload`'s, resolve rate 1.0. The
    device profile is stubbed."""
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
    monkeypatch.setattr(chip_smoke, "ROOT", tmp_path)
    assert arch in chip_smoke.SERVE_DENSE
    cfg = tconfigs.smoke_config(arch)
    launches, per_step, summary = chip_smoke.serve_model(
        torch, mmad_mod, cfg, torch.device("cpu"))
    out = capsys.readouterr().out
    gemms = 7 * cfg.n_layers + 1
    assert launches == (chip_smoke.PROMPT + chip_smoke.GEN) * gemms
    assert sum(r["count"] for r in per_step.values()) == gemms
    # lm_head on `embed.T` (tied), M = BATCH at every step
    assert per_step[(chip_smoke.BATCH, cfg.vocab, cfg.d_model,
                     "torch.bfloat16")]["count"] == 1
    assert summary["first_step_rel_l2"] <= chip_smoke.FIRST_STEP_REL_L2
    assert "resolve rate 1.0" in out
