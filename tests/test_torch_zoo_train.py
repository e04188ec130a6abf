"""Parity of training the three dense families in the port with the JAX
reference: olmo-1b (non-parametric LayerNorm, tied), phi4-mini-3.8b (GQA
4/2 at smoke width, tied) and qwen3-14b (qk-norm, head_dim 16, untied).

One routed fp32 train step of each smoke config at `microbatches=2,
compress_grads=True` (the setting of examples/torch_train_lm.py, which no
card phase covers), from the reference's weights carried with
`params_from_numpy`, on the same `SyntheticLM` batch, through one plan
cache that the port's `launch.train.warm_train_plans` warms. Tolerances
are tests/test_torch_train.py's for gemma-2b at fp32:

- the loss within 1e-5 relative, the grad norm too;
- the step's gradients (the microbatches' fp32 mean, as each package hands
  it to the compression: the reference's read in its jitted step through a
  `jax.debug.callback`) at rtol = atol = 1e-4, the K-scaled fp32
  summation-order tolerance of ROADMAP.md queue 3;
- the compression residuals and the grads the optimizer saw (the first
  moments over (1 - b1): compressed and clipped) at the same tolerance,
  but where an element's int8 level differs between the packages (see
  `_flipped`); that element's residual must then be one quantum from the
  reference's and its raw value within fp32 summation noise of a half
  quantum (rounding half to even sends it either way), at most one
  element in a thousand, and its moment is held to the reference's clip
  factor times the port's transmitted value;
- the parameters after the step with `assert_first_adam_step`.
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
from repro.optim import compress as jcompress  # noqa: E402
from repro.train import steps as jsteps  # noqa: E402
from repro_torch import configs as tconfigs  # noqa: E402
from repro_torch.launch import mesh as tmesh  # noqa: E402
from repro_torch.launch import train as ttrain  # noqa: E402
from repro_torch.models import model as tmodel  # noqa: E402
from repro_torch.models import shard_ctx as tctx  # noqa: E402
from repro_torch.optim import adamw as tadamw  # noqa: E402
from repro_torch.optim import compress as tcompress  # noqa: E402
from repro_torch.train import steps as tsteps  # noqa: E402
from test_torch_gpu import assert_first_adam_step  # noqa: E402
from test_torch_moe_train import _np, _port_named, _rel  # noqa: E402

BATCH, SEQ, MICROBATCHES = 4, 32, 2
DENSE = ["olmo-1b", "phi4-mini-3.8b", "qwen3-14b"]
TOL = dict(rtol=1e-4, atol=1e-4)


def _flipped(tres, jres, grads):
    """The elements, by name, whose int8 level differs between the two
    packages' compression of the same step; asserts that each is a
    rounding of a raw value that sits within fp32 summation noise of a
    half quantum (the residual one quantum from the reference's), that
    they are at most one in a thousand, and that every other residual
    agrees at TOL. Quanta are the reference's: each leaf (a stacked
    group's blocks in order, `compress._stacks`) flattened, in blocks of
    `compress.BLOCK`, max |g| / 127 each."""
    flipped, n = {}, 0
    for names in tcompress._stacks(tres):
        flat = np.concatenate([grads[k].ravel() for k in names])
        blocks = np.pad(flat, (0, (-flat.size) % tcompress.BLOCK)).reshape(
            -1, tcompress.BLOCK)
        quanta = np.repeat(np.abs(blocks).max(1) / 127.0 + 1e-12,
                           tcompress.BLOCK)[:flat.size]
        start = 0
        for k in names:
            q = quanta[start:start + grads[k].size].reshape(grads[k].shape)
            start += grads[k].size
            diff = np.abs(tres[k] - jres[k])
            apart = diff > TOL["atol"] + TOL["rtol"] * np.abs(jres[k])
            half = np.abs(np.abs(grads[k]) / q % 1 - 0.5)
            assert (np.abs(diff - q) <= 1e-3 * q)[apart].all(), k
            assert (half <= 1e-3)[apart].all(), k
            flipped[k] = apart
            n += grads[k].size
    assert sum(int(f.sum()) for f in flipped.values()) <= 1e-3 * n
    return flipped


@pytest.mark.parametrize("arch", DENSE)
def test_routed_dense_train_step_matches_reference(arch, tmp_path, capsys,
                                                   monkeypatch):
    jcfg = dataclasses.replace(jconfigs.smoke_config(arch),
                               dtype=jnp.float32)
    tcfg = dataclasses.replace(tconfigs.smoke_config(arch),
                               dtype=torch.float32)
    jparams = jmodel.init_params(jax.random.PRNGKey(0), jcfg)
    tparams = tmodel.make_trainable(tmodel.params_from_numpy(
        jax.tree.map(np.asarray, jparams), tcfg, device="cpu"))
    assert (tparams.lm_head is None) == tcfg.tie_embeddings
    old = {k: _np(v).copy() for k, v in tparams.named_parameters()}
    names = list(old)
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

    # each package's step gradients as its compression receives them
    seen = {}
    real_j, real_t = jcompress.apply, tcompress.apply

    def japply(grads, state):
        jax.debug.callback(lambda g: seen.update(j=g), grads)
        return real_j(grads, state)

    def tapply(grads, state, layout=None):
        seen["t"] = {k: _np(g).copy() for k, g in grads.items()}
        return real_t(grads, state, layout)
    monkeypatch.setattr(jcompress, "apply", japply)
    monkeypatch.setattr(tcompress, "apply", tapply)

    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    tb = {k: torch.from_numpy(v).long() for k, v in batch.items()}
    with jctx.gemm_context(jc):
        jp, jst, jcomp, jm = jax.jit(jsteps.make_train_step(
            jcfg, jopt, MICROBATCHES, compress_grads=True))(
            jparams, jadamw.init(jparams), jcompress.init(jparams), jb)
        jax.block_until_ready(jp)
    with tctx.gemm_context(tc):
        tp, tst, tcomp, tm = tsteps.make_train_step(
            tcfg, topt, MICROBATCHES, compress_grads=True)(
            tparams, tadamw.init(tparams), tcompress.init(tparams), tb)
    capsys.readouterr()

    assert tc.stats.resolve_rate == jc.stats.resolve_rate == 1.0
    assert tc.stats.silent_degrades == 0
    keys = {(tag, tuple(dataclasses.astuple(s)))
            for tag, s in tc.stats.observed}
    assert keys == {(tag, tuple(dataclasses.astuple(s)))
                    for tag, s in jc.stats.observed}
    # each microbatch's lm_head chunk, on `embed.T` when tied
    assert ("lm_head.chunked", (BATCH // MICROBATCHES * SEQ, tcfg.vocab,
                                tcfg.d_model)) in {
        (tag, (s.m, s.n, s.k)) for tag, s in tc.stats.observed}

    assert np.isfinite(float(tm["loss"]))
    assert _rel(tm["loss"], jm["loss"]) <= 1e-5
    assert _rel(tm["grad_norm"], jm["grad_norm"]) <= 1e-5
    assert float(tm["lr"]) == pytest.approx(float(jm["lr"]), rel=1e-7)

    jgrads = _port_named(seen["j"])
    assert list(seen["t"]) == names and set(jgrads) == set(names)
    for k in names:
        np.testing.assert_allclose(seen["t"][k], jgrads[k], err_msg=k, **TOL)
    jres = _port_named(jcomp.residual)
    tres = {k: _np(tcomp.residual[k]) for k in names}
    # the compression sent something other than the raw gradient
    assert any(np.abs(tres[k]).max() > 0 for k in names)
    flipped = _flipped(tres, jres, jgrads)

    # the clipped, compressed grads: mu / (1 - b1) = c * (g - residual),
    # c the clip factor; where the levels differ, the reference's clip
    # factor times the port's transmitted value
    jmu = _port_named(jst.mu)
    g_t = {k: _np(tst.mu[k]) / (1 - topt.b1) for k in names}
    g_j = {k: jmu[k] / (1 - jopt.b1) for k in names}
    clip = np.sqrt(sum((g_j[k].astype(np.float64) ** 2).sum()
                       for k in names)
                   / sum(((jgrads[k] - jres[k]).astype(np.float64) ** 2).sum()
                         for k in names))
    assert 0 < clip <= 1 + 1e-6
    for k in names:
        want = np.where(flipped[k], clip * (jgrads[k] - tres[k]), g_j[k])
        np.testing.assert_allclose(g_t[k], want, err_msg=k, **TOL)

    new_t = {k: _np(v) for k, v in tp.named_parameters()}
    check = dict(old=old, new_j=_port_named(jp), g_t=g_t, g_j=g_j,
                 lr=float(jm["lr"]), wd=topt.weight_decay, eps=topt.eps,
                 bf16=set())
    assert_first_adam_step(new_t=new_t, **check)
    with pytest.raises(AssertionError):
        assert_first_adam_step(new_t=old, **check)
