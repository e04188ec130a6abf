"""Multi-rank parity of the port's mesh dataflows with the JAX reference.

Four gloo processes on the CPU stand in for the reference's XLA fake host
devices: NCCL puts one rank on each card, so on one H100 no multi-rank path
runs. The processes meet through a FileStore under the test's tmp_path
(pytest runs under xdist, so no TCP port is taken). One spawn runs every
case of a test; the reference runs in one subprocess that sets its own
`XLA_FLAGS` (tests/conftest.py forbids leaking them), on meshes with
`axis_types=(AxisType.Auto,)*2`; both start together and are joined with a
timeout of their own. Inputs come from numpy with a seed; every rank must
return the reference's global output and gradients.

- Every `dit_gemm` mode (`auto`, `summa`, `cannon` with and without
  `overlap`, `splitk` with both scatter policies, `splitk_summa` and
  `hierarchical` / `outer_systolic` on every view `mesh_views` lists, and
  `allgather`) on 2x2, 4x1 and 1x4 meshes, with and without a plan's
  `InnerKernel`, forward and both gradients. Tolerance as in
  tests/test_torch_gemm.py: both sides accumulate fp32, so rtol 1e-5 and
  atol 1e-5·sqrt(K) with K the contraction length of each product.
- `flat_attention`'s merge and ring compositions on 4x1 and 2x2 (heads
  sharded over the column axis and replicated), and a decode-shaped merge
  with positions and cache lengths: forward and the gradients of q, k and
  v, at rtol 1e-5 and atol 1e-5·sqrt(skv).
- The slice as a whole, as the reference's own routed-attention check
  (tests/test_attention_flat.py `ROUTED_ATTENTION_BODY`): smoke-width
  gemma-2b (fp32) carried over with `params_from_numpy`, one routed
  `decode_step` and a routed prefill `forward` on 4x1 and 2x2 meshes, plans
  tuned for a grid of the mesh's shape. Resolve rate 1.0, no fallback, no
  silent degrade, `flat_merge` used, and the logits match the reference's
  routed logits on the same fake mesh at rtol = atol = 1e-4 (fp32 sums of
  a few hundred products taken in other orders through three layers).

This file imports neither jax nor the JAX package; the reference runs in
its subprocess.
"""
import json
import math
import os
import subprocess
import sys
import textwrap
import types

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.core.lower import mesh_views  # noqa: E402

SRC = os.path.join(os.path.dirname(__file__), "..", "src")
WORLD = 4
MESHES = ((2, 2), (4, 1), (1, 4))
M, K, N = 16, 32, 24
INNER_KERNEL = (8, 64, 32, "float32")
TIMEOUT_S = 240


def _axes(mode, k_axis=None):
    axes = {"row": "data", "col": "model"}
    if mode in ("splitk", "splitk_summa"):
        axes["k"] = k_axis
    if mode in ("hierarchical", "outer_systolic"):
        axes.update(inner_row="data_in", inner_col="model_in")
    return axes


def gemm_cases():
    """(id, case) for every mode on every mesh, deterministic."""
    out = []
    for dm, dn in MESHES:
        sizes = {"data": dm, "model": dn}
        tag = f"{dm}x{dn}"
        plain = [("auto", {}, None, False, False)]
        for mode in ("summa", "allgather"):
            plain += [(mode, {}, None, False, ik) for ik in (False, True)]
        plain += [("splitk", {"scatter": sc}, None, False, ik)
                  for sc in (True, False) for ik in (False, True)]
        if dm == dn:
            plain += [("cannon", {}, None, ov, ik)
                      for ov in (False, True) for ik in (False, True)]
        for view in mesh_views(sizes):
            names = [name for _, subs in view.splits for name, _ in subs]
            vs = view.axis_sizes(types.SimpleNamespace(
                axis_names=("data", "model"), shape=sizes))
            splits = [[ax, [list(s) for s in subs]] for ax, subs in
                      view.splits]
            if "splitk" in names:
                plain += [("splitk_summa", {"scatter": sc}, splits, False, ik)
                          for sc in (True, False) for ik in (False, True)]
                continue
            modes = ["hierarchical"]
            if vs["data"] == vs["model"]:
                modes.append("outer_systolic")
            plain += [(mode, {}, splits, ov, ik) for mode in modes
                      for ov in (False, True) for ik in (False, True)]
        for mode, kw, splits, ov, ik in plain:
            k_axis = "model" if dn > 1 else "data"
            if mode == "splitk_summa":
                k_axis = "splitk"
            name = "-".join(
                [tag, mode]
                + ([f"scatter={kw['scatter']}"] if "scatter" in kw else [])
                + (["view=" + ",".join(f"{n}{s}" for _, subs in splits
                                       for n, s in subs)] if splits else [])
                + (["overlap"] if ov else []) + (["ik"] if ik else []))
            out.append((name, {"mesh": [dm, dn], "mode": mode,
                               "axes": _axes(mode, k_axis), "kwargs": kw,
                               "view": splits, "overlap": ov, "ik": ik}))
    return out


def attn_cases():
    """(id, case): merge and ring on 4x1 and 2x2, heads sharded over the
    column axis or replicated, and a decode-shaped merge (sq 1, positions
    and cache lengths)."""
    base = {"b": 2, "sq": 8, "skv": 8, "h": 4, "hkv": 2, "d": 8}
    out = []
    for mesh, comp, head_shard in (((4, 1), "merge", False),
                                   ((4, 1), "ring", False),
                                   ((2, 2), "merge", True),
                                   ((2, 2), "ring", True),
                                   ((2, 2), "merge", False)):
        out.append((f"{mesh[0]}x{mesh[1]}-{comp}"
                    + ("-heads_sharded" if head_shard else ""),
                    dict(base, mesh=list(mesh), composition=comp,
                         head_shard=head_shard, decode=False)))
    out.append(("4x1-merge-decode", dict(base, sq=1, mesh=[4, 1],
                                         composition="merge",
                                         head_shard=False, decode=True)))
    return out


GEMM_CASES = gemm_cases()
ATTN_CASES = attn_cases()
SLICE_MESHES = ((4, 1), (2, 2))
SLICE_TOKENS = (4, 8)                   # batch x prompt


def _attn_inputs(case, seed):
    rng = np.random.default_rng(seed)
    b, sq, skv, h, hkv, d = (case[k] for k in ("b", "sq", "skv", "h", "hkv",
                                               "d"))
    x = {"q": rng.standard_normal((b, sq, h, d)),
         "k": rng.standard_normal((b, skv, hkv, d)),
         "v": rng.standard_normal((b, skv, hkv, d)),
         "g": rng.standard_normal((b, sq, h, d))}
    x = {key: val.astype(np.float32) for key, val in x.items()}
    if case["decode"]:
        x["q_positions"] = np.array([5], np.int32)
        x["kv_len"] = np.array([6, 4], np.int32)
    return x


def write_inputs(path):
    rng = np.random.default_rng(0)
    arrays = {"a": rng.standard_normal((M, K)).astype(np.float32),
              "b": rng.standard_normal((K, N)).astype(np.float32),
              "g": rng.standard_normal((M, N)).astype(np.float32)}
    for i, (name, case) in enumerate(ATTN_CASES):
        for key, val in _attn_inputs(case, 100 + i).items():
            arrays[f"{name}/{key}"] = val
    # smoke gemma-2b's vocabulary is 256 tokens
    arrays["slice/tokens"] = rng.integers(0, 256, SLICE_TOKENS).astype(
        np.int32)
    np.savez(path, **arrays)


# ---------------------------------------------------------------------------
# the reference, in one subprocess with four fake host devices
# ---------------------------------------------------------------------------

REFERENCE = textwrap.dedent("""
    import dataclasses, os, sys, json
    os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
    import jax
    import jax.numpy as jnp
    import numpy as np
    from jax.sharding import AxisType
    from repro.core import gemm, lower, attention
    from repro.core.schedule import InnerKernel

    spec = json.load(open(sys.argv[1]))
    x = dict(np.load(spec["inputs"]))
    meshes = {}

    def mesh_of(shape):
        key = tuple(shape)
        if key not in meshes:
            meshes[key] = jax.make_mesh(key, ("data", "model"),
                                        axis_types=(AxisType.Auto,) * 2)
        return meshes[key]

    out = {}
    a, b, g = (jnp.asarray(x[k]) for k in "abg")
    for name, c in spec["gemm"]:
        ik = InnerKernel(*spec["inner_kernel"][:3],
                         dtype=spec["inner_kernel"][3]) if c["ik"] else None
        view = (lower.MeshView(splits=tuple(
                    (ax, tuple((n, s) for n, s in subs))
                    for ax, subs in c["view"])) if c["view"] else None)
        plan = lower.ExecPlan(mode=c["mode"], axes=c["axes"],
                              kwargs=c["kwargs"], view=view,
                              requested=c["mode"], grid=(1, 1, 1),
                              shape=(0, 0, 0), inner_kernel=ik,
                              overlap=c["overlap"])
        mesh = mesh_of(c["mesh"])

        def fwd_bwd(p, q, ct, mesh=mesh, plan=plan):
            y, vjp = jax.vjp(
                lambda p, q: gemm.exec_plan_gemm(p, q, mesh, plan), p, q)
            return (y, *vjp(ct))

        res = jax.jit(fwd_bwd)(a, b, g)
        for key, val in zip(("out", "ga", "gb"), res):
            out[name + "/" + key] = np.asarray(val)
    for name, c in spec["attn"]:
        plan = lower.ExecPlan(
            mode="flat_" + c["composition"],
            axes={"row": "data", "col": "model"},
            kwargs={"composition": c["composition"],
                    "head_shard": c["head_shard"], "kv_chunk": 256},
            view=None, requested="flat_attention", grid=(1, 1, 1),
            shape=(0, 0, 0))
        mesh = mesh_of(c["mesh"])
        extra = ({"q_positions": jnp.asarray(x[name + "/q_positions"]),
                  "kv_len": jnp.asarray(x[name + "/kv_len"])}
                 if c["decode"] else {})
        q, k, v = (jnp.asarray(x[name + "/" + t]) for t in "qkv")

        def fwd_bwd(q, k, v, ct, mesh=mesh, plan=plan, extra=extra):
            y, vjp = jax.vjp(lambda q, k, v: attention.flat_attention(
                q, k, v, mesh, plan, causal=True, **extra), q, k, v)
            return (y, *vjp(ct))

        res = jax.jit(fwd_bwd)(q, k, v, jnp.asarray(x[name + "/g"]))
        for key, val in zip(("out", "gq", "gk", "gv"), res):
            out[name + "/" + key] = np.asarray(val)

    # the slice: smoke gemma-2b (fp32) routed on each mesh
    import pickle
    from repro.configs import smoke_config
    from repro.deploy import Planner, model_workload
    from repro.hw.config import (AcceleratorConfig, HBMConfig, NoCConfig,
                                 TileConfig)
    from repro.models import model, shard_ctx
    cfg = dataclasses.replace(smoke_config("gemma-2b"), dtype=jnp.float32)
    params = model.init_params(jax.random.PRNGKey(0), cfg)
    with open(spec["params"], "wb") as f:
        pickle.dump(jax.tree.map(np.asarray, params), f)
    open(spec["params"] + ".done", "w").close()
    toks = jnp.asarray(x["slice/tokens"])
    stats = {}
    for shape in spec["slice_meshes"]:
        tag = "%dx%d" % tuple(shape)
        hw = AcceleratorConfig(name="mini", grid=tuple(shape),
                               tile=TileConfig(l1_bytes=4 * 1024 * 1024),
                               noc=NoCConfig(), hbm=HBMConfig(n_channels=8))
        planner = Planner(hw, elem_bytes=4, max_candidates=8)
        b, s = toks.shape
        planner.batch_tune(list(dict.fromkeys(
            model_workload(cfg, b, s, kind="decode")
            + model_workload(cfg, b, s, kind="prefill"))), skip_illegal=True)
        ctx = shard_ctx.GemmContext(mesh=mesh_of(shape), planner=planner)
        shard_ctx.set_gemm_context(ctx)
        caches = model.decode_init(params, cfg, batch=b, max_len=s)
        decode = jax.jit(lambda p, c, t: model.decode_step(
            p, c, t, jnp.asarray(0, jnp.int32), cfg))
        logits, _ = decode(params, caches, toks[:, :1])
        out["slice/" + tag + "/decode"] = np.asarray(logits, np.float32)
        prefill = jax.jit(lambda p, t: model.forward(p, t, cfg))
        out["slice/" + tag + "/prefill"] = np.asarray(prefill(params, toks),
                                                      np.float32)
        shard_ctx.set_gemm_context(None)
        st = ctx.stats
        stats[tag] = {"resolve_rate": st.resolve_rate,
                      "fallback": st.fallback,
                      "silent": st.silent_degrades, "modes": st.modes}
    json.dump(stats, open(spec["ref_stats"], "w"))
    np.savez(spec["out"], **out)
    print("REFERENCE_OK")
""")


# ---------------------------------------------------------------------------
# the port, in four gloo processes
# ---------------------------------------------------------------------------

def _gemm_rank(spec, x, mesh_cache):
    from repro_torch.core import gemm, lower
    from repro_torch.core.schedule import InnerKernel
    out = {}
    a0, b0, g0 = (torch.from_numpy(x[k]) for k in "abg")
    for name, c in spec["gemm"]:
        mesh = mesh_cache(tuple(c["mesh"]))
        ik = (InnerKernel(*spec["inner_kernel"][:3],
                          dtype=spec["inner_kernel"][3]) if c["ik"] else None)
        view = (lower.MeshView(splits=tuple(
            (ax, tuple((n, s) for n, s in subs)) for ax, subs in c["view"]))
            if c["view"] else None)
        plan = lower.ExecPlan(mode=c["mode"], axes=c["axes"],
                              kwargs=c["kwargs"], view=view,
                              requested=c["mode"], grid=(1, 1, 1),
                              shape=(0, 0, 0), inner_kernel=ik,
                              overlap=c["overlap"])
        a = a0.clone().requires_grad_(True)
        b = b0.clone().requires_grad_(True)
        y = gemm.exec_plan_gemm(a, b, mesh, plan)
        y.backward(g0)
        out[name + "/out"] = y.detach().numpy()
        out[name + "/ga"], out[name + "/gb"] = a.grad.numpy(), b.grad.numpy()
    return out


def _attn_rank(spec, x, mesh_cache):
    from repro_torch.core import attention, lower
    out = {}
    for name, c in spec["attn"]:
        mesh = mesh_cache(tuple(c["mesh"]))
        plan = lower.ExecPlan(
            mode="flat_" + c["composition"],
            axes={"row": "data", "col": "model"},
            kwargs={"composition": c["composition"],
                    "head_shard": c["head_shard"], "kv_chunk": 256},
            view=None, requested="flat_attention", grid=(1, 1, 1),
            shape=(0, 0, 0))
        extra = ({"q_positions": torch.from_numpy(x[name + "/q_positions"]),
                  "kv_len": torch.from_numpy(x[name + "/kv_len"])}
                 if c["decode"] else {})
        qkv = [torch.from_numpy(x[name + "/" + t]).requires_grad_(True)
               for t in "qkv"]
        y = attention.flat_attention(*qkv, mesh, plan, causal=True, **extra)
        y.backward(torch.from_numpy(x[name + "/g"]))
        out[name + "/out"] = y.detach().numpy()
        for t, tensor in zip("qkv", qkv):
            out[name + "/g" + t] = tensor.grad.numpy()
    return out


def _slice_rank(spec, x, mesh_cache):
    """Smoke gemma-2b (fp32, the reference's weights) routed on each mesh:
    one decode step and a prefill forward."""
    import dataclasses
    import pickle
    from repro_torch.configs import smoke_config
    from repro_torch.deploy import Planner, model_workload
    from repro_torch.hw.config import (AcceleratorConfig, HBMConfig,
                                       NoCConfig, TileConfig)
    from repro_torch.models import model, shard_ctx
    cfg = dataclasses.replace(smoke_config("gemma-2b"), dtype=torch.float32)
    with open(spec["params"], "rb") as f:
        params = model.params_from_numpy(pickle.load(f), cfg, device="cpu")
    toks = torch.from_numpy(x["slice/tokens"]).long()
    b, s = toks.shape
    out, stats = {}, {}
    for shape in spec["slice_meshes"]:
        tag = "%dx%d" % tuple(shape)
        hw = AcceleratorConfig(name="mini", grid=tuple(shape),
                               tile=TileConfig(l1_bytes=4 * 1024 * 1024),
                               noc=NoCConfig(), hbm=HBMConfig(n_channels=8))
        planner = Planner(hw, elem_bytes=4, max_candidates=8)
        planner.batch_tune(list(dict.fromkeys(
            model_workload(cfg, b, s, kind="decode")
            + model_workload(cfg, b, s, kind="prefill"))), skip_illegal=True)
        ctx = shard_ctx.GemmContext(mesh=mesh_cache(tuple(shape)),
                                    planner=planner)
        with shard_ctx.gemm_context(ctx), torch.inference_mode():
            caches = model.decode_init(params, cfg, b, s)
            logits, _ = model.decode_step(params, caches, toks[:, :1], 0, cfg)
            out[f"slice/{tag}/decode"] = logits.numpy()
            out[f"slice/{tag}/prefill"] = model.forward(params, toks,
                                                        cfg).numpy()
        st = ctx.stats
        stats[tag] = {"resolve_rate": st.resolve_rate,
                      "fallback": st.fallback, "silent": st.silent_degrades,
                      "modes": st.modes, "executed_gemm": st.executed_gemm,
                      "executed_attn": st.executed_attn}
    return out, stats


def _worker(rank, store_path, spec_path):
    import torch.distributed as dist
    from repro_torch.launch.mesh import make_dist_mesh, make_host_mesh
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{store_path}",
                            rank=rank, world_size=WORLD)
    try:
        spec = json.load(open(spec_path))
        x = dict(np.load(spec["inputs"]))
        meshes = {}

        def mesh_cache(shape):
            # every rank makes the meshes in the same order: collective
            if shape not in meshes:
                meshes[shape] = make_dist_mesh(shape, "cpu")
            return meshes[shape]

        host = make_host_mesh("cpu")      # collective, as the meshes below
        host_info = {"type": type(host).__name__, "shape": dict(host.shape),
                     "data": host.coord("data"), "size": host.size}
        for shape in spec["meshes"] + spec["slice_meshes"]:
            mesh_cache(tuple(shape))
        out = _gemm_rank(spec, x, mesh_cache)
        out.update(_attn_rank(spec, x, mesh_cache))
        # the slice needs the reference's weights, which its subprocess
        # writes first
        import time
        deadline = time.monotonic() + TIMEOUT_S
        while not os.path.exists(spec["params"] + ".done"):
            if time.monotonic() > deadline:
                raise TimeoutError("the reference wrote no weights")
            time.sleep(0.2)
        slice_out, stats = _slice_rank(spec, x, mesh_cache)
        stats["host_mesh"] = host_info
        out.update(slice_out)
        np.savez(spec["port_out"].format(rank=rank), **out)
        with open(spec["port_stats"].format(rank=rank), "w") as f:
            json.dump(stats, f)
    finally:
        dist.destroy_process_group()


def run_ranks(target, args, timeout=TIMEOUT_S):
    """Spawn WORLD processes of `target(rank, *args)`; join each within
    the shared timeout, kill what is left, and fail on any exit code."""
    import time
    ctx = torch.multiprocessing.get_context("spawn")
    procs = [ctx.Process(target=target, args=(r, *args)) for r in range(WORLD)]
    for p in procs:
        p.start()
    deadline = time.monotonic() + timeout
    try:
        for p in procs:
            p.join(max(0.0, deadline - time.monotonic()))
    finally:
        alive = [p for p in procs if p.is_alive()]
        for p in alive:
            p.kill()
            p.join()
    assert not alive, f"{len(alive)} ranks still running after {timeout}s"
    codes = [p.exitcode for p in procs]
    assert codes == [0] * WORLD, f"rank exit codes {codes}"


def start_reference(body, spec_path):
    env = dict(os.environ)
    env["PYTHONPATH"] = SRC + os.pathsep + env.get("PYTHONPATH", "")
    env.pop("XLA_FLAGS", None)
    env["JAX_PLATFORMS"] = "cpu"
    return subprocess.Popen([sys.executable, "-c", body, spec_path], env=env,
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                            text=True)


def finish_reference(proc, marker):
    try:
        stdout, stderr = proc.communicate(timeout=TIMEOUT_S)
    except subprocess.TimeoutExpired:
        proc.kill()
        stdout, stderr = proc.communicate()
    assert proc.returncode == 0 and marker in stdout, (
        f"reference failed ({proc.returncode}):\n{stdout}\n{stderr[-4000:]}")


@pytest.fixture(scope="module")
def modes_run(tmp_path_factory):
    """One reference subprocess and one spawn of four ranks for every mode
    and attention case; both run at once."""
    tmp = tmp_path_factory.mktemp("dist_modes")
    spec = {"inputs": str(tmp / "inputs.npz"), "out": str(tmp / "ref.npz"),
            "port_out": str(tmp / "port{rank}.npz"),
            "inner_kernel": list(INNER_KERNEL),
            "meshes": [list(m) for m in MESHES],
            "gemm": GEMM_CASES, "attn": ATTN_CASES,
            "params": str(tmp / "params.pkl"),
            "ref_stats": str(tmp / "ref_stats.json"),
            "port_stats": str(tmp / "port_stats{rank}.json"),
            "slice_meshes": [list(m) for m in SLICE_MESHES]}
    write_inputs(spec["inputs"])
    spec_path = tmp / "spec.json"
    spec_path.write_text(json.dumps(spec))
    proc = start_reference(REFERENCE, str(spec_path))
    try:
        run_ranks(_worker, (str(tmp / "store"), str(spec_path)))
    finally:
        finish_reference(proc, "REFERENCE_OK")
    ref = dict(np.load(spec["out"]))
    ports = [dict(np.load(spec["port_out"].format(rank=r)))
             for r in range(WORLD)]
    ref["stats"] = json.loads(open(spec["ref_stats"]).read())
    for r, port in enumerate(ports):
        port["stats"] = json.loads(open(spec["port_stats"].format(
            rank=r)).read())
    return ref, ports


def _close(got, want, k):
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5 * math.sqrt(k))


@pytest.mark.parametrize("name,case", GEMM_CASES,
                         ids=[name for name, _ in GEMM_CASES])
def test_mode_matches_reference_on_every_rank(modes_run, name, case):
    ref, ports = modes_run
    for rank, port in enumerate(ports):
        for key, k in (("out", K), ("ga", N), ("gb", M)):
            assert port[f"{name}/{key}"].shape == ref[f"{name}/{key}"].shape
            _close(port[f"{name}/{key}"], ref[f"{name}/{key}"], k)


@pytest.mark.parametrize("name,case", ATTN_CASES,
                         ids=[name for name, _ in ATTN_CASES])
def test_flat_attention_matches_reference_on_every_rank(modes_run, name,
                                                        case):
    ref, ports = modes_run
    for port in ports:
        for key in ("out", "gq", "gk", "gv"):
            _close(port[f"{name}/{key}"], ref[f"{name}/{key}"], case["skv"])


def test_cases_cover_every_mode_view_and_knob():
    """The case list holds every mode of `dit_gemm` on each mesh it is
    legal on, both scatter policies, overlap on and off, and every view
    of `mesh_views`."""
    by_mesh = {}
    for _, c in GEMM_CASES:
        by_mesh.setdefault(tuple(c["mesh"]), set()).add(c["mode"])
    base = {"auto", "summa", "allgather", "splitk", "splitk_summa",
            "hierarchical"}
    assert by_mesh[(2, 2)] == base | {"cannon", "outer_systolic"}
    assert by_mesh[(4, 1)] == by_mesh[(1, 4)] == base
    assert {c["kwargs"].get("scatter") for _, c in GEMM_CASES} == {
        True, False, None}
    assert {c["overlap"] for _, c in GEMM_CASES} == {True, False}
    assert {c["ik"] for _, c in GEMM_CASES} == {True, False}
    for shape in MESHES:
        views = {json.dumps(c["view"]) for _, c in GEMM_CASES
                 if tuple(c["mesh"]) == shape and c["view"]}
        assert len(views) == len(mesh_views(dict(zip(("data", "model"),
                                                     shape))))


@pytest.mark.parametrize("shape", SLICE_MESHES,
                         ids=[f"{dm}x{dn}" for dm, dn in SLICE_MESHES])
def test_routed_smoke_gemma_matches_reference(modes_run, shape):
    """Smoke gemma-2b routed on the mesh, every rank: resolve rate 1.0, no
    fallback, no silent degrade, the merge composition on decode, and the
    reference's routed logits for one decode step and a prefill forward."""
    ref, ports = modes_run
    tag = f"{shape[0]}x{shape[1]}"
    want = ref["stats"][tag]
    assert want["resolve_rate"] == 1.0 and want["silent"] == 0
    for port in ports:
        st = port["stats"][tag]
        assert st["resolve_rate"] == 1.0, st
        assert st["fallback"] == 0 and st["silent"] == 0, st
        assert st["modes"].get("flat_merge", 0) > 0, st
        assert st["modes"].get("unfused_attn", 0) == 0, st
        assert set(st["modes"]) == set(want["modes"]), (st, want)
        assert st["executed_gemm"] > 0 and st["executed_attn"] > 0, st
        for kind in ("decode", "prefill"):
            got = port[f"slice/{tag}/{kind}"]
            assert np.isfinite(got).all()
            np.testing.assert_allclose(got, ref[f"slice/{tag}/{kind}"],
                                       rtol=1e-4, atol=1e-4)


def test_make_host_mesh_is_a_dist_mesh_over_the_world(modes_run):
    """With a world of four ranks initialised, the launchers' mesh is a
    (4, 1) `DistMesh` holding each rank at its own row, as the reference's
    `make_host_mesh` lays out four devices."""
    _, ports = modes_run
    for rank, port in enumerate(ports):
        assert port["stats"]["host_mesh"] == {
            "type": "DistMesh", "shape": {"data": WORLD, "model": 1},
            "data": rank, "size": WORLD}
