"""Parity of the port's traffic replay (`launch/traffic.py`, `serve
--traffic`) with the JAX package's, and a CPU rehearsal of `chip_smoke.py`'s
traffic phase.

- `generate_trace` gives the reference's trace request for request (the
  same floats: both draw from `random.Random(f"{seed}:{tenant}")`).
- `simulate` on the port's planner gives the reference's `serving_section`
  on the reference's planner (each warmed by its own `warm_pool` into its
  own cache directory, same grid and candidate count) in both batch modes,
  for two tenants of smoke gemma-2b and for a mixed pair of smoke gemma-2b
  and smoke deepseek-moe-16b: integers and strings exactly, floats within
  1e-12 relative (the same arithmetic in the same order; the bound leaves
  room for nothing but a last-bit difference).
- The behaviour cases of tests/test_serving.py's replay (completion,
  first-encounter charge, fallback penalty, one dispatch per shape, the
  section's schema) run on the port against the same stub planner, and the
  stub's sections equal the reference's.
- `serve.main([... "--traffic" ...])` on the CPU writes a run report whose
  `serving` section equals the reference's `simulate` on the same trace.
"""
import dataclasses
import json
import math
from types import SimpleNamespace

import pytest

torch = pytest.importorskip("torch")

from repro.configs import smoke_config as jsmoke  # noqa: E402
from repro.deploy import planner as jplanner_mod  # noqa: E402
from repro.deploy.batcher import BatchPolicy as JPolicy  # noqa: E402
from repro.deploy.batcher import Request as JRequest  # noqa: E402
from repro.deploy.warmup import build_planner as jbuild  # noqa: E402
from repro.hw import config as jhw  # noqa: E402
from repro.launch import traffic as jtraffic  # noqa: E402
from repro_torch.configs import smoke_config as tsmoke  # noqa: E402
from repro_torch.deploy import planner as tplanner_mod  # noqa: E402
from repro_torch.deploy.batcher import BatchPolicy as TPolicy  # noqa: E402
from repro_torch.deploy.batcher import Request as TRequest  # noqa: E402
from repro_torch.deploy.warmup import build_planner as tbuild  # noqa: E402
from repro_torch.hw import config as thw  # noqa: E402
from repro_torch.launch import serve as tserve  # noqa: E402
from repro_torch.launch import traffic as ttraffic  # noqa: E402
from repro_torch.models import shard_ctx as tctx  # noqa: E402
from repro_torch.obs import set_tracer  # noqa: E402
from test_torch_serve import ROOT  # noqa: E402

GRID, CANDIDATES = (4, 4), 4
MODES = ("bucket", "fifo")
# tenant name -> arch; serve --traffic's tenants, and a mixed pair
TENANT_SETS = {
    "gemma": {"tenant0": "gemma-2b", "tenant1": "gemma-2b"},
    "mixed": {"gemma": "gemma-2b", "moe": "deepseek-moe-16b"},
}


def _traffic_config(traffic_mod, tenants, seed=0, n=12, rate=100.0):
    """serve --traffic's tenant specs (prompts 5-17, gens 2-5)."""
    return traffic_mod.TrafficConfig(seed=seed, tenants=tuple(
        traffic_mod.TenantSpec(name=name, arch=arch, rate_rps=rate,
                               n_requests=n, prompt_lens=(5, 9, 13, 17),
                               gen_lens=(2, 3, 5))
        for name, arch in tenants.items()))


def _key(r):
    return (r.rid, r.tenant, r.arrival_s, r.prompt_len, r.gen_len, r.slo_s)


def assert_section_equal(got, want, where="serving"):
    """Integers, strings and booleans exactly; floats within 1e-12
    relative (exactly where the reference's is 0)."""
    if isinstance(want, dict):
        assert set(got) == set(want), where
        for key in want:
            assert_section_equal(got[key], want[key], f"{where}.{key}")
    elif isinstance(want, float):
        assert isinstance(got, float), where
        assert got == pytest.approx(want, rel=1e-12, abs=0), where
    else:
        assert type(got) is type(want) and got == want, where


@pytest.mark.parametrize("seed,n,rate", [(0, 12, 100.0), (3, 20, 300.0),
                                         (11, 6, 50.0)])
@pytest.mark.parametrize("tenants", sorted(TENANT_SETS))
def test_generate_trace_equals_reference(tenants, seed, n, rate):
    want = jtraffic.generate_trace(_traffic_config(
        jtraffic, TENANT_SETS[tenants], seed, n, rate))
    got = ttraffic.generate_trace(_traffic_config(
        ttraffic, TENANT_SETS[tenants], seed, n, rate))
    assert len(got) == len(want) == n * len(TENANT_SETS[tenants])
    assert [_key(r) for r in got] == [_key(r) for r in want]


def _replay(traffic_mod, build, smoke, policy_cls, cache, tenants, mode):
    """Warm a fresh planner's pool in `cache`, replay the seed-0 trace."""
    tcfg = _traffic_config(traffic_mod, tenants)
    policy = policy_cls(mode=mode)
    cfgs = {name: smoke(arch) for name, arch in tenants.items()}
    planner = build(str(cache), GRID, CANDIDATES)
    warmed = traffic_mod.warm_pool(planner, {c.name: c for c in cfgs.values()},
                                   policy, tcfg.max_rows(policy))
    result = traffic_mod.simulate(traffic_mod.generate_trace(tcfg), planner,
                                  cfgs, policy=policy, precompiled=warmed)
    return traffic_mod.serving_section(result), result


@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("tenants", sorted(TENANT_SETS))
def test_simulate_section_equals_reference(tenants, mode, tmp_path):
    want, jres = _replay(jtraffic, jbuild, jsmoke, JPolicy,
                         tmp_path / "jax", TENANT_SETS[tenants], mode)
    got, tres = _replay(ttraffic, tbuild, tsmoke, TPolicy,
                        tmp_path / "torch", TENANT_SETS[tenants], mode)
    assert_section_equal(got, want)
    assert got["requests"] == 24 and got["resolve_rate"] == 1.0
    for trec, jrec in zip(tres.records, jres.records):
        assert (trec.rid, trec.ttft_s, trec.done_s) == pytest.approx(
            (jrec.rid, jrec.ttft_s, jrec.done_s), rel=1e-12, abs=0)
    if mode == "fifo":      # ragged M's: transfers or online tunes, cold
        prefill = got["per_phase"]["prefill"]
        assert prefill["bucketed"] + prefill["analytic"] > 0
        assert got["cold_shapes"] > 0
    else:                   # every M on the warmed pow-2 pool
        assert got["cold_shapes"] == 0


# ---------------------------------------------------------------------------
# tests/test_serving.py's replay behaviour, on the port (stub planner)
# ---------------------------------------------------------------------------

STUB_CFG = SimpleNamespace(
    name="stub", d_model=64, hd=16, n_heads=4, n_kv_heads=2, d_ff=256,
    vocab=1000, attn="gqa", n_experts=0, moe_top_k=0, moe_d_ff=0,
    q_lora_rank=0, kv_lora_rank=0, rope_head_dim=0, nope_head_dim=0)


class StubPlanner:
    """tests/test_serving.py's stub: pow-2 M serves a tuned hit, ragged M
    an analytic plan, M in `unplanned` no plan (the fallback path); the
    cost is a deterministic function of the shape."""

    def __init__(self, hw_mod, unplanned=()):
        self.hw = hw_mod.AcceleratorConfig(
            name="mini", grid=(4, 4),
            tile=hw_mod.TileConfig(l1_bytes=4 * 1024 * 1024),
            noc=hw_mod.NoCConfig(), hbm=hw_mod.HBMConfig(n_channels=8))
        self.elem_bytes = 4
        self.unplanned = set(unplanned)

    def plan_cached(self, shape):
        if shape.m in self.unplanned:
            return None
        source = "tuned" if shape.m & (shape.m - 1) == 0 else "analytic"
        return SimpleNamespace(
            source=source,
            report=SimpleNamespace(total_time=1e-6 * shape.m + 1e-5))


def _stub_traffic(traffic_mod, seed=3, n=12):
    return traffic_mod.TrafficConfig(seed=seed, tenants=(
        traffic_mod.TenantSpec(name="a", rate_rps=300.0, n_requests=n,
                               prompt_lens=(5, 9, 13), gen_lens=(1, 2, 3)),
        traffic_mod.TenantSpec(name="b", rate_rps=200.0, n_requests=n,
                               prompt_lens=(7, 11), gen_lens=(1, 2)),
    ))


def _stub_sim(pkg, mode="bucket", unplanned=(), trace=None, **kw):
    traffic_mod, hw_mod, policy_cls = pkg
    if trace is None:
        trace = traffic_mod.generate_trace(_stub_traffic(traffic_mod))
    return traffic_mod.simulate(trace, StubPlanner(hw_mod, unplanned),
                                {"a": STUB_CFG, "b": STUB_CFG},
                                policy=policy_cls(mode=mode), **kw)


PORT = (ttraffic, thw, TPolicy)
REF = (jtraffic, jhw, JPolicy)


def _completes(mode):
    trace = ttraffic.generate_trace(_stub_traffic(ttraffic))
    result = _stub_sim(PORT, mode=mode, trace=trace)
    assert len(result.records) == len(trace)
    for rec in result.records:
        assert math.isfinite(rec.ttft_s) and rec.ttft_s >= 0
        assert math.isfinite(rec.done_s)
        assert rec.latency_s >= rec.ttft_s > 0 or rec.gen_len == 0
    assert result.makespan_s >= max(r.done_s for r in result.records) - 1e-12
    assert result.batches > 0 and result.dispatches > 0
    assert_section_equal(ttraffic.serving_section(result),
                         jtraffic.serving_section(_stub_sim(REF, mode=mode)))


def _first_encounter_charges_once():
    """Cold shapes pay the virtual first-launch charge exactly once; a
    fully precompiled pool pays none and finishes strictly earlier."""
    cold = _stub_sim(PORT)
    assert cold.cold_shapes == cold.distinct_shapes > 0
    pool = []
    for m in range(1, 200):
        pool += tplanner_mod.model_workload(STUB_CFG, batch=m, seq=1,
                                            kind="prefill")
        pool += tplanner_mod.model_workload(STUB_CFG, batch=m, seq=1,
                                            kind="decode")
    warm = _stub_sim(PORT, precompiled=pool)
    assert warm.cold_shapes == 0
    assert warm.makespan_s < cold.makespan_s
    jpool = []
    for m in range(1, 200):
        for kind in ("prefill", "decode"):
            jpool += jplanner_mod.model_workload(STUB_CFG, batch=m, seq=1,
                                                 kind=kind)
    assert_section_equal(
        ttraffic.serving_section(warm),
        jtraffic.serving_section(_stub_sim(REF, precompiled=jpool)))


def _request(request_cls):
    return [request_cls(rid=0, tenant="a", arrival_s=0.0, prompt_len=8,
                        gen_len=1, slo_s=math.inf)]


def _fallback_pays_penalty():
    """Unplanned shapes land in the fallback tally and the resolve rate
    drops below 1; the penalty multiplies the roofline floor."""
    trace = _request(TRequest)
    assert _stub_sim(PORT, trace=trace).resolve_rate == 1.0
    bad = _stub_sim(PORT, trace=trace, unplanned={1, 8})
    assert bad.resolve_rate < 1.0
    assert sum(c["fallback"] for c in bad.per_phase.values()) > 0
    dear = _stub_sim(PORT, trace=trace, unplanned={1, 8},
                     costs=ttraffic.ServingCosts(fallback_penalty=1e4))
    assert dear.makespan_s > bad.makespan_s
    assert_section_equal(
        ttraffic.serving_section(dear),
        jtraffic.serving_section(_stub_sim(
            REF, trace=_request(JRequest), unplanned={1, 8},
            costs=jtraffic.ServingCosts(fallback_penalty=1e4))))


def _dispatch_once_per_shape():
    seen = []
    result = _stub_sim(PORT, dispatch=lambda shape, phase: seen.append(
        (shape, phase)))
    shapes = [shape for shape, _ in seen]
    assert len(shapes) == len(set(shapes)) == result.distinct_shapes
    assert {phase for _, phase in seen} == {"prefill", "decode"}
    # the hook changes nothing the replay decides
    assert ttraffic.serving_section(result) == ttraffic.serving_section(
        _stub_sim(PORT))


def _schema():
    section = ttraffic.serving_section(_stub_sim(PORT))
    for key in ("policy", "requests", "met", "missed", "deadline_miss_rate",
                "good_tokens", "total_tokens", "goodput_tps",
                "throughput_tps", "p50_latency_s", "p99_latency_s",
                "p50_ttft_s", "p99_ttft_s", "makespan_s", "batches",
                "cold_shapes", "distinct_shapes", "mean_batch_utilization",
                "resolve_rate", "per_phase"):
        assert key in section, key
    json.dumps(section)                           # report-embeddable
    for phase in ("prefill", "decode"):
        sub = section["per_phase"][phase]
        assert {"hit", "bucketed", "analytic", "fallback", "dispatches",
                "hit_rate", "resolve_rate"} <= set(sub)
    assert section["goodput_tps"] <= section["throughput_tps"] + 1e-9
    assert section["p50_latency_s"] <= section["p99_latency_s"] + 1e-12
    assert set(section) == set(jtraffic.serving_section(_stub_sim(REF)))


BEHAVIOUR = {
    "completes-bucket": lambda: _completes("bucket"),
    "completes-fifo": lambda: _completes("fifo"),
    "first-encounter-charges-once": _first_encounter_charges_once,
    "fallback-pays-penalty": _fallback_pays_penalty,
    "dispatch-once-per-shape": _dispatch_once_per_shape,
    "schema": _schema,
}


@pytest.mark.parametrize("case", list(BEHAVIOUR))
def test_replay_behaviour(case):
    BEHAVIOUR[case]()


def test_serving_costs_are_the_reference_charges():
    assert dataclasses.asdict(ttraffic.ServingCosts()) == \
        dataclasses.asdict(jtraffic.ServingCosts())


# ---------------------------------------------------------------------------
# serve --traffic, end to end on the CPU
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("mode", MODES)
def test_serve_traffic_report_equals_reference(mode, tmp_path, capsys):
    report_path, trace_path = tmp_path / "rr.json", tmp_path / "trace.json"
    try:
        returned = tserve.main([
            "--arch", "gemma-2b", "--smoke", "--device", "cpu", "--traffic",
            "--batch-mode", mode, "--plan-cache", str(tmp_path / "torch"),
            "--plan-candidates", str(CANDIDATES),
            "--run-report", str(report_path), "--trace", str(trace_path)])
        ctx = tctx.get_gemm_context()
    finally:
        tctx.set_gemm_context(None)
        set_tracer(None)
    out = capsys.readouterr().out
    assert "traffic replay: 24 requests / 2 tenant(s)" in out
    report = json.loads(report_path.read_text())
    assert report == json.loads(json.dumps(returned))
    want, _ = _replay(jtraffic, jbuild, jsmoke, JPolicy, tmp_path / "jax",
                      TENANT_SETS["gemma"], mode)
    assert_section_equal(report["serving"], json.loads(json.dumps(want)))
    assert report["traffic"] == {"seed": 0, "tenants": 2, "requests": 24,
                                 "rate_rps": 100.0, "batch_mode": mode}
    assert report["device"] == "cpu" and report["launcher"] == "serve"
    # one routed pmm per distinct shape, every one resolved
    stats = ctx.stats
    assert stats.resolve_rate == 1.0 and stats.silent_degrades == 0
    assert stats.executed_gemm == report["serving"]["distinct_shapes"]
    assert {tag for tag, _ in ctx.resolved} <= {"traffic.prefill",
                                                "traffic.decode"}
    events = json.loads(trace_path.read_text())["traceEvents"]
    assert sum(e.get("name") == "serve.request" for e in events) == 24


def _chip_smoke(monkeypatch):
    import importlib
    monkeypatch.syspath_prepend(str(ROOT))
    return importlib.import_module("chip_smoke")


def test_chip_smoke_traffic_phase_rehearsed_on_cpu(monkeypatch, tmp_path,
                                                   capsys):
    """`chip_smoke.serve_traffic` in both modes on smoke gemma-2b with CPU
    tensors and `ops.mmad` counted (the CPU path counts no launches); the
    phase's own checks run: the report's section equal to `simulate`'s
    without dispatch on the same trace and planner, one launch per
    distinct shape, one `serve.request` marker per request, each M's
    route (an H100's SM count on the CPU)."""
    import importlib
    chip_smoke = _chip_smoke(monkeypatch)
    mmad_mod = importlib.import_module("repro_torch.kernels.mmad")
    from repro_torch.kernels import ops
    real = ops.mmad

    def counted(a, b, *args, **kw):
        mmad_mod._launches += 1
        return real(a, b, *args, **kw)
    monkeypatch.setattr(ops, "mmad", counted)
    monkeypatch.setattr(chip_smoke, "ROOT", tmp_path)
    cfg = tsmoke("gemma-2b")
    summaries = {}
    for i, mode in enumerate(chip_smoke.TRAFFIC_MODES):
        summaries[mode] = chip_smoke.serve_traffic(
            torch, mmad_mod, torch.device("cpu"), mode, smoke=True,
            fresh=i == 0)
    out = capsys.readouterr().out
    for mode, summary in summaries.items():
        assert summary["launches"] == summary["serving"]["distinct_shapes"] \
            == len(summary["table"]) > 0
        assert summary["serving"]["policy"] == mode
        assert all(info["count"] == 1 and info["dtype"] == cfg.dtype
                   for info in summary["table"].values())
    ms = {mode: {key[0] for key in s["table"]} for mode, s in
          summaries.items()}
    assert all(m & (m - 1) == 0 for m in ms["bucket"])
    assert any(m & (m - 1) for m in ms["fifo"])
    assert "virtual clock" in out
    assert "traffic [fifo] routes by M: 1: row stream" in out
