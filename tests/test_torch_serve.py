"""Parity of the PyTorch port's serving slice with the JAX reference.

- Plans: for the full gemma-2b serve workload (batch 4, prompt 32, gen 32)
  both packages tune identical schedules (`describe()` / `to_dict()`) and
  lower them to identical 1x1 `ExecPlan`s; a plan cache warmed by the
  reference serves the port with hits.
- Routed decode: the gemma-2b smoke config decodes a few tokens in both
  packages from the same weights (the reference's pytree carried across
  with `params_from_numpy`) under a routed `GemmContext`. At fp32 the
  logits agree at rtol = atol = 1e-4; at bf16 at rtol 2e-2, atol 5e-2 —
  the logits are bf16 values of magnitude ~2, whose ulp is 1.6e-2, and
  bf16 rounds at different points in the two frameworks (the gelu, the
  softmax, the attention output) — with equal greedy tokens. The observed (tag, shape)
  sets and each key's mode, reasons and provenance match, and the
  plan-resolve rate is 1.0 in both.
- Import hygiene: `repro_torch` imports with jax blocked, and no module of
  it (nor `chip_smoke.py`) imports jax or the reference package.
- No CPU fallback: with no card and no `--device cpu`, serving raises.

The reference mesh uses Auto axis types (see tests/test_torch_gemm.py).
"""
import ast
import dataclasses
import json
import os
import pathlib
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
from jax.sharding import AxisType  # noqa: E402

from repro import configs as jconfigs  # noqa: E402
from repro.core.lower import lower_schedule as jlower_schedule  # noqa: E402
from repro.core.schedule import GEMMShape as JGEMMShape  # noqa: E402
from repro.deploy import model_workload as jmodel_workload  # noqa: E402
from repro.deploy.plan import schedule_to_dict as jschedule_to_dict  # noqa: E402
from repro.launch import serve as jserve  # noqa: E402
from repro.models import model as jmodel  # noqa: E402
from repro.models import shard_ctx as jctx  # noqa: E402
from repro.obs import Tracer as JTracer  # noqa: E402
from repro.obs import dispatch_provenance as jprovenance  # noqa: E402
from repro.obs import set_tracer as jset_tracer  # noqa: E402
from repro.train.steps import make_serve_step as jmake_serve_step  # noqa: E402
from repro_torch import configs as tconfigs  # noqa: E402
from repro_torch.core.lower import lower_schedule as tlower_schedule  # noqa: E402
from repro_torch.deploy import model_workload as tmodel_workload  # noqa: E402
from repro_torch.deploy.plan import schedule_to_dict as tschedule_to_dict  # noqa: E402
from repro_torch.deploy.warmup import build_planner as tbuild_planner  # noqa: E402
from repro_torch.launch import mesh as tmesh  # noqa: E402
from repro_torch.launch import serve as tserve  # noqa: E402
from repro_torch.models import attention as tattn  # noqa: E402
from repro_torch.models import model as tmodel  # noqa: E402
from repro_torch.models import shard_ctx as tctx  # noqa: E402
from repro_torch.obs import Tracer as TTracer  # noqa: E402
from repro_torch.obs import dispatch_provenance as tprovenance  # noqa: E402
from repro_torch.obs import set_tracer as tset_tracer  # noqa: E402
from repro_torch.train.steps import make_serve_step as tmake_serve_step  # noqa: E402

ROOT = pathlib.Path(__file__).resolve().parents[1]
BATCH, PROMPT, GEN = 4, 32, 32
ONE_BY_ONE = tmesh.HostMesh(device=torch.device("cpu"))


def _jax_mesh():
    return jax.make_mesh((1, 1), ("data", "model"),
                         axis_types=(AxisType.Auto,) * 2)


def _workload(model_workload, cfg, batch, prompt, gen):
    return list(dict.fromkeys(
        model_workload(cfg, batch, prompt, kind="prefill")
        + model_workload(cfg, batch, prompt + gen, kind="decode")))


# ---------------------------------------------------------------------------
# plans
# ---------------------------------------------------------------------------

def test_full_gemma_plans_and_lowerings_identical(tmp_path, capsys):
    jcfg, tcfg = jconfigs.get_config("gemma-2b"), tconfigs.get_config("gemma-2b")
    jp = jserve.warm_plan_cache(jcfg, BATCH, PROMPT, PROMPT + GEN,
                                str(tmp_path / "j"), (4, 4), 12)
    tp = tserve.warm_plan_cache(tcfg, BATCH, PROMPT, PROMPT + GEN,
                                str(tmp_path / "t"), (4, 4), 12)
    jw = _workload(jmodel_workload, jcfg, BATCH, PROMPT, GEN)
    tw = _workload(tmodel_workload, tcfg, BATCH, PROMPT, GEN)
    assert [(s.m, s.n, s.k) for s in jw] == [(s.m, s.n, s.k) for s in tw]
    modes = set()
    for js, ts in zip(jw, tw):
        jplan, tplan = jp.plan(js), tp.plan(ts)
        assert tplan.schedule.describe() == jplan.schedule.describe()
        assert (tschedule_to_dict(tplan.schedule)
                == jschedule_to_dict(jplan.schedule))
        assert tplan.source == jplan.source
        assert tplan.report.total_time == jplan.report.total_time
        jep = jlower_schedule(jplan.schedule, _jax_mesh(), shape=js)
        tep = tlower_schedule(tplan.schedule, ONE_BY_ONE, shape=ts)
        assert tep.to_dict() == jep.to_dict()
        modes.add(tep.mode)
    # on one card every routed GEMM lowers to a single-kernel mode
    assert modes <= {"summa", "splitk"}
    capsys.readouterr()


def test_reference_warmed_cache_serves_the_port(tmp_path, capsys):
    cache = str(tmp_path / "plans")
    jcfg, tcfg = jconfigs.get_config("gemma-2b"), tconfigs.get_config("gemma-2b")
    jp = jserve.warm_plan_cache(jcfg, BATCH, PROMPT, PROMPT + GEN, cache,
                                (4, 4), 12)
    tp = tbuild_planner(cache, (4, 4), 12)
    decode = tmodel_workload(tcfg, BATCH, PROMPT + GEN, kind="decode")
    for shape in decode:
        plan = tp.plan_cached(shape)
        jplan = jp.plan_cached(JGEMMShape(shape.m, shape.n, shape.k))
        assert plan.schedule.describe() == jplan.schedule.describe()
        assert plan.source == jplan.source
    assert tp.cache.stats.hits == len(decode)
    assert tp.cache.stats.misses == 0 and not tp.pending_refinements
    capsys.readouterr()


# ---------------------------------------------------------------------------
# routed decode with carried weights
# ---------------------------------------------------------------------------

def _decode_jax(cfg, params, prompts, gen, cache_dir):
    planner = jserve.warm_plan_cache(cfg, prompts.shape[0], prompts.shape[1],
                                     prompts.shape[1] + gen, cache_dir,
                                     (4, 4), 12)
    ctx = jctx.GemmContext(mesh=_jax_mesh(), planner=planner)
    tracer = JTracer(process_name="parity")
    jset_tracer(tracer)
    try:
        with jctx.gemm_context(ctx):
            serve = jax.jit(jmake_serve_step(cfg))
            caches = jmodel.decode_init(params, cfg, prompts.shape[0],
                                        prompts.shape[1] + gen)
            logits_seq, toks = [], []
            for i in range(prompts.shape[1]):
                logits, caches = serve(params, caches,
                                       jnp.asarray(prompts[:, i:i + 1]),
                                       jnp.asarray(i))
                logits_seq.append(np.asarray(logits))
            for i in range(gen):
                tok = np.asarray(jnp.argmax(logits, -1))[:, None]
                toks.append(tok[:, 0])
                logits, caches = serve(params, caches, jnp.asarray(tok),
                                       jnp.asarray(prompts.shape[1] + i))
                logits_seq.append(np.asarray(logits))
    finally:
        jset_tracer(None)
    return np.stack(logits_seq), np.stack(toks, 1), ctx.stats, jprovenance(tracer)


def _decode_torch(cfg, params, prompts, gen, cache_dir):
    planner = tserve.warm_plan_cache(cfg, prompts.shape[0], prompts.shape[1],
                                     prompts.shape[1] + gen, cache_dir,
                                     (4, 4), 12)
    ctx = tctx.GemmContext(mesh=tmesh.make_host_mesh("cpu"), planner=planner)
    tracer = TTracer(process_name="parity")
    tset_tracer(tracer)
    try:
        with tctx.gemm_context(ctx), torch.inference_mode():
            serve = tmake_serve_step(cfg)
            caches = tmodel.decode_init(params, cfg, prompts.shape[0],
                                        prompts.shape[1] + gen)
            logits_seq, toks = [], []
            tp = torch.from_numpy(prompts).long()
            for i in range(prompts.shape[1]):
                logits, caches = serve(params, caches, tp[:, i:i + 1], i)
                logits_seq.append(logits.numpy())
            for i in range(gen):
                tok = torch.argmax(logits, -1)[:, None]
                toks.append(tok[:, 0].numpy())
                logits, caches = serve(params, caches, tok,
                                       prompts.shape[1] + i)
                logits_seq.append(logits.numpy())
    finally:
        tset_tracer(None)
    return np.stack(logits_seq), np.stack(toks, 1), ctx.stats, tprovenance(tracer)


def _decisions(prov):
    return {(r["tag"], tuple(r["shape"]), r["mode"], tuple(r.get("reasons", ())),
             r["provenance"]) for r in prov}


@pytest.mark.parametrize("dtype,rtol,atol", [("float32", 1e-4, 1e-4),
                                             ("bfloat16", 2e-2, 5e-2)])
def test_routed_smoke_decode_matches_reference(dtype, rtol, atol, tmp_path,
                                               capsys):
    jcfg = dataclasses.replace(jconfigs.smoke_config("gemma-2b"),
                               dtype=getattr(jnp, dtype))
    tcfg = dataclasses.replace(tconfigs.smoke_config("gemma-2b"),
                               dtype=getattr(torch, dtype))
    jparams = jmodel.init_params(jax.random.PRNGKey(0), jcfg)
    tree = jax.tree.map(np.asarray, jparams)
    tparams = tmodel.params_from_numpy(tree, tcfg, device="cpu")
    prompts = np.random.default_rng(0).integers(0, jcfg.vocab, (2, 4))

    jl, jt, jstats, jprov = _decode_jax(jcfg, jparams, prompts, 4,
                                        str(tmp_path / "j"))
    tl, tt, tstats, tprov = _decode_torch(tcfg, tparams, prompts, 4,
                                          str(tmp_path / "t"))
    np.testing.assert_allclose(tl, jl, rtol=rtol, atol=atol)
    np.testing.assert_array_equal(tt, jt)
    assert np.isfinite(tl).all()

    def keys(observed):
        return {(tag, tuple(dataclasses.astuple(s))) for tag, s in observed}
    assert keys(tstats.observed) == keys(jstats.observed)
    assert keys(tstats.attn_observed) == keys(jstats.attn_observed)
    assert set(tstats.modes) == set(jstats.modes)
    assert set(tstats.degrades) == set(jstats.degrades)
    assert _decisions(tprov) == _decisions(jprov)
    assert tstats.resolve_rate == jstats.resolve_rate == 1.0
    assert tstats.silent_degrades == jstats.silent_degrades == 0
    # the port resolves each (tag, shape) once and counts every dispatch
    assert sum(tstats.observed.values()) == len(tstats.observed)
    steps = prompts.shape[1] + 4
    per_step = 7 * tcfg.n_layers + 1
    assert tstats.executed_gemm == steps * per_step
    assert tstats.executed_attn == steps * tcfg.n_layers
    capsys.readouterr()


def test_unrouted_forward_matches_reference():
    """`forward` without a context is x @ w throughout (fp32 smoke)."""
    jcfg = dataclasses.replace(jconfigs.smoke_config("gemma-2b"),
                               dtype=jnp.float32)
    tcfg = dataclasses.replace(tconfigs.smoke_config("gemma-2b"),
                               dtype=torch.float32)
    jparams = jmodel.init_params(jax.random.PRNGKey(1), jcfg)
    tparams = tmodel.params_from_numpy(jax.tree.map(np.asarray, jparams),
                                       tcfg, device="cpu")
    toks = np.random.default_rng(2).integers(0, jcfg.vocab, (2, 8))
    want = np.asarray(jmodel.forward(jparams, jnp.asarray(toks), jcfg))
    with torch.inference_mode():
        got = tmodel.forward(tparams, torch.from_numpy(toks).long(), tcfg)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-4, atol=1e-4)
    assert tcfg.param_count() == jcfg.param_count()


# ---------------------------------------------------------------------------
# the launcher
# ---------------------------------------------------------------------------

def test_serve_main_on_cpu_writes_a_resolved_run_report(tmp_path, capsys):
    report = tmp_path / "report.json"
    tserve.main(["--arch", "gemma-2b", "--smoke", "--device", "cpu",
                 "--batch", "2", "--prompt-len", "4", "--gen", "4",
                 "--plan-cache", str(tmp_path / "plans"),
                 "--run-report", str(report)])
    tctx.set_gemm_context(None)
    tset_tracer(None)
    out = capsys.readouterr().out
    assert "plan-resolve-rate=100%" in out
    routing = json.loads(report.read_text())["routing"]
    assert routing["resolve_rate"] == 1.0 and routing["silent_degrades"] == 0
    assert routing["executed"]["gemm"] == 8 * (7 * 3 + 1)


def test_serve_without_a_card_raises(monkeypatch):
    """No CPU fallback: the entry points run on the card unless the caller
    asks for the CPU, and raise when there is none."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tserve.main(["--arch", "gemma-2b", "--smoke", "--skip-plan-warmup"])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tmesh.make_host_mesh()
    with pytest.raises(NotImplementedError, match="not yet ported"):
        tserve.main(["--arch", "gemma-2b", "--smoke", "--traffic"])


@pytest.mark.parametrize("entry", ["init_params", "params_from_numpy",
                                   "make_kv_cache"])
def test_model_entry_points_default_to_the_card(monkeypatch, entry):
    """Weights and caches go on the card unless the caller names the CPU;
    with no card the default raises instead of landing on the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = tconfigs.smoke_config("gemma-2b")
    call = {
        "init_params": lambda: tmodel.init_params(torch.Generator(), cfg),
        "params_from_numpy": lambda: tmodel.params_from_numpy({}, cfg),
        "make_kv_cache": lambda: tattn.make_kv_cache(cfg, 1, 4),
    }[entry]
    with pytest.raises(RuntimeError, match="no CUDA device"):
        call()


# ---------------------------------------------------------------------------
# import hygiene
# ---------------------------------------------------------------------------

def _port_files():
    files = sorted((ROOT / "src" / "repro_torch").rglob("*.py"))
    return files + [ROOT / "chip_smoke.py"]


def test_no_port_module_imports_jax_or_the_reference():
    bad = []
    for path in _port_files():
        for node in ast.walk(ast.parse(path.read_text(), str(path))):
            if isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            elif isinstance(node, ast.ImportFrom) and node.level == 0:
                names = [node.module or ""]
            else:
                continue
            bad += [f"{path.relative_to(ROOT)}:{node.lineno} {n}"
                    for n in names if n.split(".")[0] in ("jax", "jaxlib",
                                                          "repro")]
    assert not bad, bad


def test_port_imports_with_jax_blocked():
    code = (
        "import sys, pkgutil, importlib\n"
        "sys.modules['jax'] = None\n"
        "import repro_torch\n"
        "for m in pkgutil.walk_packages(repro_torch.__path__, 'repro_torch.'):\n"
        "    importlib.import_module(m.name)\n"
        "assert not any(k == 'repro' or k.startswith('repro.') "
        "for k in sys.modules), 'reference package imported'\n"
        "print('ok')\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True,
                          text=True, env=env, cwd=str(ROOT))
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip() == "ok"
