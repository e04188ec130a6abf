"""Parity of the port's `chunked_sdpa` (flash attention past 1024 tokens)
with the JAX reference's.

- `chunked_sdpa` forward and the grads of q, k and v, fp32, against the
  reference's `chunked_sdpa` (its `custom_vjp`) on the same numpy-seeded
  inputs: causal and not, GQA groups of 1, 2 and 8, whole and ragged
  lengths (the tail chunk padded and masked), at rtol = atol = 1e-4 (fp32
  sums over chunks taken in another order); and against the port's own
  `_sdpa`, which materialises the logits, at the same tolerance.
- Ragged tails: the padded query rows get no cotangent, so dq of the real
  rows and dk, dv are those of an unpadded run.
- `accounting.chunk` honours `CHUNK_OVERRIDE`.
- A smoke train step at seq 1040 (> 1024, so the attention takes
  `chunked_sdpa`), unrouted, fp32: loss within 1e-5 relative and grads at
  rtol = atol = 1e-4 of the reference's `value_and_grad`, then one AdamW
  step whose reported loss is the reference's.
"""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from repro import configs as jconfigs  # noqa: E402
from repro.data import pipeline as jdata  # noqa: E402
from repro.models import attention as jattn  # noqa: E402
from repro.models import model as jmodel  # noqa: E402
from repro.optim import adamw as jadamw  # noqa: E402
from repro.train import steps as jsteps  # noqa: E402
from repro_torch import configs as tconfigs  # noqa: E402
from repro_torch.models import accounting as taccounting  # noqa: E402
from repro_torch.models import attention as tattn  # noqa: E402
from repro_torch.models import model as tmodel  # noqa: E402
from repro_torch.optim import adamw as tadamw  # noqa: E402
from repro_torch.train import steps as tsteps  # noqa: E402

TOL = dict(rtol=1e-4, atol=1e-4)

# (batch, seq, heads, kv heads, head dim, chunk)
CASES = [
    (2, 256, 4, 4, 16, 64),      # groups of 1, whole chunks
    (1, 300, 4, 2, 16, 64),      # groups of 2, ragged tail (300 = 4x64 + 44)
    (1, 200, 8, 1, 32, 64),      # groups of 8 (MQA), ragged
]


def _inputs(b, s, h, hkv, d, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(shape).astype(np.float32)
            for shape in ((b, s, h, d), (b, s, hkv, d), (b, s, hkv, d),
                          (b, s, h, d))]


def _torch_run(fn, q, k, v, ct):
    xs = [torch.tensor(x, requires_grad=True) for x in (q, k, v)]
    out = fn(*xs)
    (out * torch.tensor(ct)).sum().backward()
    return [out.detach().numpy()] + [x.grad.numpy() for x in xs]


@pytest.mark.parametrize("causal", [True, False], ids=["causal", "full"])
@pytest.mark.parametrize("case", CASES,
                         ids=[f"s{c[1]}-h{c[2]}-kv{c[3]}" for c in CASES])
def test_chunked_sdpa_matches_reference(case, causal):
    b, s, h, hkv, d, chunk = case
    q, k, v, ct = _inputs(b, s, h, hkv, d)

    def jloss(q, k, v):
        out = jattn.chunked_sdpa(q, k, v, causal, chunk, chunk)
        return (out * ct).sum(), out
    (_, jout), jgrads = jax.value_and_grad(jloss, argnums=(0, 1, 2),
                                           has_aux=True)(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    want = [np.asarray(jout)] + [np.asarray(g) for g in jgrads]

    got = _torch_run(lambda q, k, v: tattn.chunked_sdpa(
        q, k, v, causal, chunk, chunk), q, k, v, ct)
    plain = _torch_run(lambda q, k, v: tattn._sdpa(q, k, v, causal),
                       q, k, v, ct)
    for name, g, w, p in zip(("out", "dq", "dk", "dv"), got, want, plain):
        np.testing.assert_allclose(g, w, err_msg=name, **TOL)
        np.testing.assert_allclose(g, p, err_msg=name, **TOL)


def test_padded_query_rows_get_no_cotangent():
    """A ragged length pads q to a whole chunk; the padded rows' outputs are
    sliced off, so the grads equal those of a run whose chunk divides the
    length (no padding at all)."""
    q, k, v, ct = _inputs(1, 200, 4, 2, 16, seed=3)
    padded = _torch_run(lambda q, k, v: tattn.chunked_sdpa(
        q, k, v, True, 64, 64), q, k, v, ct)        # 200 = 3x64 + 8
    whole = _torch_run(lambda q, k, v: tattn.chunked_sdpa(
        q, k, v, True, 40, 40), q, k, v, ct)        # 200 = 5x40
    for g, w in zip(padded, whole):
        np.testing.assert_allclose(g, w, **TOL)
        assert np.isfinite(g).all()


def test_chunk_override(monkeypatch):
    assert taccounting.chunk(256) == 256
    monkeypatch.setattr(taccounting, "CHUNK_OVERRIDE", 128)
    assert taccounting.chunk(256) == 128
    q, k, v, ct = _inputs(1, 256, 2, 1, 8)
    calls = []
    real = tattn._block_logits

    def counted(q_blk, k, qi, kj, *args):
        calls.append((qi, kj))
        return real(q_blk, k, qi, kj, *args)
    monkeypatch.setattr(tattn, "_block_logits", counted)
    with torch.no_grad():
        tattn.chunked_sdpa(*(torch.tensor(x) for x in (q, k, v)), False)
    assert sorted(calls) == [(0, 0), (0, 1), (1, 0), (1, 1)]


def test_train_step_past_1024_tokens_takes_chunked_sdpa(monkeypatch):
    seq = 1040
    jcfg = dataclasses.replace(jconfigs.smoke_config("qwen3-14b"),
                               n_layers=2, dtype=jnp.float32)
    tcfg = dataclasses.replace(tconfigs.smoke_config("qwen3-14b"),
                               n_layers=2, dtype=torch.float32)
    jparams = jmodel.init_params(jax.random.PRNGKey(0), jcfg)
    tparams = tmodel.make_trainable(tmodel.params_from_numpy(
        jax.tree.map(np.asarray, jparams), tcfg, device="cpu"))
    batch = jdata.SyntheticLM(jdata.DataConfig(
        vocab=jcfg.vocab, seq_len=seq, global_batch=1)).batch(0)
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    tb = {k: torch.from_numpy(v).long() for k, v in batch.items()}

    calls = []
    real = tattn.chunked_sdpa
    monkeypatch.setattr(tattn, "chunked_sdpa",
                        lambda *a, **kw: calls.append(1) or real(*a, **kw))
    jl, jg = jax.jit(jax.value_and_grad(
        lambda p: jsteps.loss_fn(p, jb, jcfg)))(jparams)
    tl, tg = tsteps.loss_and_grads(tparams, tb, tcfg)
    # forward, then the per-layer remat recompute in the backward
    assert len(calls) == 2 * tcfg.n_layers
    assert abs(float(tl) - float(jl)) <= 1e-5 * abs(float(jl))
    want = dict(tmodel.params_from_numpy(jax.tree.map(np.asarray, jg), tcfg,
                                         device="cpu").named_parameters())
    assert set(tg) == set(want)
    for name, g in tg.items():
        np.testing.assert_allclose(g.numpy(), want[name].numpy(),
                                   err_msg=name, **TOL)

    opt = dict(lr=1e-3, warmup_steps=5, total_steps=10)
    _, _, _, jm = jax.jit(jsteps.make_train_step(
        jcfg, jadamw.AdamWConfig(**opt)))(jparams, jadamw.init(jparams),
                                          None, jb)
    step = tsteps.make_train_step(tcfg, tadamw.AdamWConfig(**opt))
    _, _, _, tm = step(tparams, tadamw.init(tparams), None, tb)
    assert abs(float(tm["loss"]) - float(jm["loss"])) <= 1e-5 * abs(
        float(jm["loss"]))
    assert np.isfinite(float(tm["grad_norm"]))
