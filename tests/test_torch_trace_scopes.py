"""The port's profiler scopes and MoE drop counters (CPU, no jax).

Every scope is `obs.trace.profile_scope`: a `record_function` range on the
profiler's clock while a profiler runs, nothing otherwise. Checked here:

- one routed deepseek-moe-16b smoke train step on the CPU host mesh, under
  `torch.profiler` (CPU activity), holds `train.step` once and each of the
  step's scopes, and the `pmm` spans of its first dispatches;
- one `dit_gemm(planner=...)` call holds `gemm.resolve`, then
  `dit_gemm.<mode>` with `mmad.launch` and then `gemm.cast` inside it;
- with no profiler running no `record_function` is entered and no MoE
  counter is made;
- `moe.dropped` is the count of `~within` that `dispatch_slots` gives on
  the same batch, at capacities that drop much, some and nothing;
- no scope the port names collides with the strings the benchmark's trace
  reader attributes by (`bench/harness/trace.py`: names starting
  `dit_gemm.`, `moe.einsums`, names ending `LocalMatmulBackward`), except
  the two scopes those strings are for;
- no scope enters `chip_smoke`'s kernel counts, whose names it matches by
  substring ("mmad", "gemm"): its device-side copy is a user annotation.
"""
import ast
import dataclasses
import pathlib

import pytest

torch = pytest.importorskip("torch")

from repro_torch.configs import smoke_config  # noqa: E402
from repro_torch.core.gemm import MODES, dit_gemm  # noqa: E402
from repro_torch.core.schedule import GEMMShape  # noqa: E402
from repro_torch.deploy.cache import PlanCache  # noqa: E402
from repro_torch.deploy.planner import Planner  # noqa: E402
from repro_torch.deploy.warmup import plan_view  # noqa: E402
from repro_torch.launch import train as launch_train  # noqa: E402
from repro_torch.launch.mesh import make_host_mesh  # noqa: E402
from repro_torch.models import moe  # noqa: E402
from repro_torch.obs import Tracer, set_tracer, tracing  # noqa: E402

ARCH = "deepseek-moe-16b"
SRC = pathlib.Path(__file__).resolve().parents[1] / "src" / "repro_torch"
STEP_SCOPES = ("train.step", "train.forward", "train.loss",
               "train.backward", "optim.clip", "optim.adamw", "gemm.cast",
               "mmad.launch", "dit_gemm.", "moe.einsums", "pmm.")
# the strings bench/harness/trace.py attributes device time by
GEMM_SCOPE, MOE_SCOPE, BACKWARD_NODE = ("dit_gemm.", "moe.einsums",
                                        "LocalMatmulBackward")


def _cpu_profile():
    return torch.profiler.profile(
        activities=[torch.profiler.ProfilerActivity.CPU])


def _annotations(prof):
    return [e for e in prof.events()
            if getattr(e, "is_user_annotation", False)]


@pytest.fixture(scope="module")
def step(tmp_path_factory):
    """A routed smoke train step's setup and state, the annotations of its
    first step under the profiler, and its tracer."""
    args = launch_train.parse_args([
        "--arch", ARCH, "--smoke", "--device", "cpu", "--batch", "2",
        "--seq", "32", "--plan-cache", str(tmp_path_factory.mktemp("pc"))])
    s = launch_train.setup(args)
    try:
        state = s.init_state()
        with _cpu_profile() as prof:
            state, _ = s.step_fn(state, s.batch_arrays(s.data.batch(0)))
        yield s, state, _annotations(prof)
    finally:
        from repro_torch.models import shard_ctx
        shard_ctx.set_gemm_context(None)
        set_tracer(None)


@pytest.mark.parametrize("scope", STEP_SCOPES)
def test_routed_step_holds_scope(step, scope):
    _, _, events = step
    names = [e.name for e in events]
    held = [n for n in names
            if n == scope or (scope.endswith(".") and n.startswith(scope))]
    assert held, (scope, sorted(set(names)))
    if scope == "train.step":
        assert len(held) == 1


def test_routed_step_counts_moe_pairs(step):
    s, _, _ = step
    counters = s.tracer.metrics.to_dict()["counters"]
    # forward and the remat recomputation each route every (token, choice)
    # of each MoE layer once
    layers = s.cfg.n_layers - s.cfg.n_dense_layers
    pairs = 2 * layers * 2 * 32 * s.cfg.moe_top_k
    assert counters["moe.pairs"] == pairs
    assert 0 <= counters["moe.dropped"] <= pairs
    assert isinstance(counters["moe.dropped"], int)


def test_no_profiler_no_record_function_no_counter(step, monkeypatch):
    s, state, _ = step
    entered = []
    monkeypatch.setattr(torch.profiler, "record_function",
                        lambda name: entered.append(name))
    tracer = Tracer(process_name="off")
    with tracing(tracer):
        s.step_fn(state, s.batch_arrays(s.data.batch(1)))
    assert entered == []
    assert not any(k.startswith("moe.")
                   for k in tracer.metrics.to_dict()["counters"])


def _planner(mesh, tmp_path):
    return Planner(plan_view((1, 1), mesh=mesh),
                   cache=PlanCache(str(tmp_path)), elem_bytes=2,
                   max_candidates=4)


def test_dit_gemm_scopes_nest(tmp_path):
    mesh = make_host_mesh("cpu")
    planner = _planner(mesh, tmp_path)
    planner.plan(GEMMShape(64, 64, 64))
    g = torch.Generator().manual_seed(0)
    a = torch.randn(64, 64, generator=g).to(torch.bfloat16)
    b = torch.randn(64, 64, generator=g).to(torch.bfloat16)
    with _cpu_profile() as prof:
        dit_gemm(a, b, mesh, planner=planner)
    ev = _annotations(prof)
    names = [e.name for e in ev]
    assert names[0] == "gemm.resolve", names
    modes = [e for e in ev if e.name.startswith(GEMM_SCOPE)]
    assert len(modes) == 1 and modes[0].name[len(GEMM_SCOPE):] in (
        MODES + ("splitk_summa", "hierarchical", "outer_systolic"))
    resolve, mode = ev[0], modes[0]
    assert resolve.time_range.end <= mode.time_range.start
    inner = [e for e in ev if e.name in ("mmad.launch", "gemm.cast")]
    assert [e.name for e in inner] == ["mmad.launch", "gemm.cast"], names
    for e in inner:
        assert e.cpu_parent is not None and e.cpu_parent.name == mode.name
        assert mode.time_range.start <= e.time_range.start
        assert e.time_range.end <= mode.time_range.end
    assert inner[0].time_range.end <= inner[1].time_range.start


def _moe_case(capacity_factor):
    cfg = dataclasses.replace(smoke_config(ARCH),
                              capacity_factor=capacity_factor,
                              dtype=torch.float32)
    g = torch.Generator().manual_seed(7)
    p = moe.moe_params(g, cfg, device="cpu")
    x = torch.randn(2, 64, cfg.d_model, generator=g)
    return cfg, p, x


@pytest.mark.parametrize("capacity_factor", [0.25, 1.25, 16.0])
def test_moe_dropped_is_within_false(capacity_factor):
    cfg, p, x = _moe_case(capacity_factor)
    tracer = Tracer(process_name="moe")
    with tracing(tracer), _cpu_profile(), torch.no_grad():
        moe.apply_moe(p, x, cfg)
    counters = tracer.metrics.to_dict()["counters"]
    t = x.shape[0] * x.shape[1]
    groups = moe._dp_groups(t)
    cap = moe._capacity(t // groups, cfg)
    with torch.no_grad():
        _, topi = moe.route(p, x.reshape(groups, t // groups, -1), cfg)
        _, within, _ = moe.dispatch_slots(topi, cfg.n_experts, cap)
    assert counters["moe.pairs"] == within.numel() == t * cfg.moe_top_k
    assert counters["moe.dropped"] == int((~within).sum())
    if capacity_factor == 16.0:
        assert counters["moe.dropped"] == 0
    if capacity_factor == 0.25:
        assert counters["moe.dropped"] > 0


def _named_scopes():
    """(file, name) of every scope the port names in its source: the
    first argument of each `profile_scope`, `span` and `maybe_span` call,
    an f-string read up to its first field (a prefix)."""
    out = []
    for path in sorted(SRC.rglob("*.py")):
        for node in ast.walk(ast.parse(path.read_text())):
            if not (isinstance(node, ast.Call) and node.args):
                continue
            fn = node.func
            called = fn.attr if isinstance(fn, ast.Attribute) else getattr(
                fn, "id", None)
            if called not in ("profile_scope", "span", "maybe_span",
                              "record_function"):
                continue
            arg = node.args[0]
            if isinstance(arg, ast.Constant) and isinstance(arg.value, str):
                out.append((path.name, arg.value))
            elif isinstance(arg, ast.JoinedStr):
                head = arg.values[0] if arg.values else None
                prefix = (head.value if isinstance(head, ast.Constant)
                          else "")
                out.append((path.name, prefix + "*"))
    return out


NAMED = _named_scopes()


def test_port_names_its_scopes():
    names = {n for _, n in NAMED}
    for scope in ("train.step", "train.forward", "train.loss",
                  "train.backward", "optim.adamw", "optim.clip",
                  "gemm.resolve", "gemm.cast", "mmad.launch",
                  "moe.einsums", "dit_gemm.*", "pmm.*", "pattn.*"):
        assert scope in names, sorted(names)


@pytest.mark.parametrize("where,name", NAMED)
def test_scope_name_leaves_bench_strings_alone(where, name):
    if (where, name) in (("gemm.py", "dit_gemm.*"), ("moe.py", MOE_SCOPE)):
        return          # the scopes those strings are for
    assert not name.startswith(GEMM_SCOPE), (where, name)
    assert name != MOE_SCOPE, (where, name)
    assert not name.rstrip("*").endswith(BACKWARD_NODE), (where, name)


def _device_profile(scope):
    """A fake profile of one `chip_smoke.device_profile` window on the
    card: spin kernels at both edges, one `mmad` kernel, and the device
    timeline's copy of a `record_function` range named `scope`, which the
    profiler flags as a user annotation (as torch's CUDA profiler does)."""
    from types import SimpleNamespace as NS
    from torch.autograd import DeviceType

    def dev_event(name, t, annotation=False):
        return NS(name=name, key=name, device_type=DeviceType.CUDA,
                  is_user_annotation=annotation, time_range=NS(start=t),
                  self_device_time_total=10.0, count=1)
    events = [dev_event("spin_kernel", 0.0), dev_event(scope, 1.0, True),
              dev_event("mmad_wgmma_kernel<bf16, 128, 256, 4>", 2.0),
              dev_event("spin_kernel", 3.0)]
    return NS(events=lambda: events, key_averages=lambda: events)


@pytest.mark.parametrize("where,name", NAMED)
def test_scope_name_leaves_chip_smoke_counts_alone(where, name, monkeypatch):
    """`chip_smoke` counts `mmad` launches by the kernel names that hold
    "mmad" (`mmad_call`) and library GEMMs by "gemm" and like words
    (`library_gemms`): a scope such as `mmad.launch` or `gemm.cast` stays
    out of both counts, and out of its busy time and edges, only because
    its device-side copy is a user annotation."""
    import importlib
    monkeypatch.syspath_prepend(str(SRC.parents[1]))
    chip_smoke = importlib.import_module("chip_smoke")
    prof = _device_profile(name.rstrip("*") + "x" * name.endswith("*"))
    rows = chip_smoke.device_kernels(torch, prof)
    assert [n for _, _, n in rows] == ["mmad_wgmma_kernel<bf16, 128, 256, 4>"]
    assert sum(chip_smoke.mmad_call(n) for _, _, n in rows) == 1
    assert chip_smoke.library_gemms(rows) == ([], [])
    assert chip_smoke.edge_counts(torch, prof) == (1, 1)
