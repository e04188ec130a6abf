"""The port's model zoo against the JAX reference's.

- The dense GQA configs olmo-1b (non-parametric LayerNorm, MHA, tied),
  phi4-mini-3.8b (GQA 4/2 at smoke width, tied) and qwen3-14b (qk-norm,
  head_dim 16 at smoke width, untied lm_head): smoke-width routed decode
  and the unrouted forward from the reference's carried weights, with the
  serve parity tolerances of tests/test_torch_serve.py (fp32 rtol = atol =
  1e-4; bf16 rtol 2e-2, atol 5e-2) and equal greedy tokens, the same
  observed (tag, shape) keys and routing decisions, resolve rate 1.0.
- The registry lists the eight ported architectures, each full and smoke
  config equal field by field to the reference's (deepseek-v2-236b's MLA
  is held to the reference in tests/test_torch_mla.py, zamba2-1.2b and
  xlstm-1.3b in tests/test_torch_ssm.py).
- The families not yet ported (encoder-decoder, the VLM frontend) raise
  `NotImplementedError` naming their ROADMAP.md item.
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
from repro_torch.models.common import ModelConfig  # noqa: E402
from test_torch_serve import (_decisions, _decode_jax,  # noqa: E402
                              _decode_torch)

PORTED = ["deepseek-moe-16b", "deepseek-v2-236b", "gemma-2b", "olmo-1b",
          "phi4-mini-3.8b", "qwen3-14b", "xlstm-1.3b", "zamba2-1.2b"]
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


@pytest.mark.parametrize("arch,family", [
    ("seamless-m4t-medium", "encoder-decoder"),
    ("phi-3-vision-4.2b", "vision_stub"),
])
def test_unported_families_raise_naming_their_roadmap_item(arch, family):
    with pytest.raises(KeyError):
        tconfigs.get_config(arch)
    cfg = ModelConfig(**{**_fields(jconfigs.smoke_config(arch)),
                         "dtype": torch.bfloat16})
    with pytest.raises(NotImplementedError,
                       match=f"{family}.*ROADMAP.md, queue 1"):
        tmodel.init_params(None, cfg, device="meta")
