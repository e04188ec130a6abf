"""Multi-rank training with sharded parameters against the JAX reference.

Four gloo processes on the CPU stand in for the reference's four fake host
devices, as in tests/test_torch_dist.py (its `run_ranks` idiom, for a
world of any size, and its `finish_reference`): NCCL puts one rank on each
card, so the multi-rank evidence is the CPU's. Everything
starts at once: two reference subprocesses (one per model, each compiling
each of its steps once, on meshes with `AxisType.Auto`), a subprocess on
the fake 256- and 512-rank worlds, and one spawn of four ranks; a spawn of
two ranks follows the four.

- **Parity.** Smoke gemma-2b and smoke deepseek-moe-16b in fp32 take two
  AdamW steps (batch 4 x seq 32, `SyntheticLM` steps 0 and 1) on the
  (2, 2) `data x model` mesh and the (2, 1, 2) `pod x data x model` mesh,
  unrouted and routed, from the reference's weights: the port through
  `launch.train.setup(..., mesh=...)` with its state sharded by
  `parallel.sharded.shard_params`; the reference's jitted
  `make_train_step` with its parameters placed by `param_shardings` and
  `shard_ctx.set_mesh` installed (its launcher's production path). The
  reference's routed MoE step aborts its XLA CPU runtime about half the
  time (`ref_key`), so the port's routed MoE step is held to the
  reference's unrouted one. Each
  step's loss within 1e-5 relative and grad norm within 1e-4 relative
  (fp32 sums taken in other orders: ROADMAP.md queue 3); the parameters,
  reassembled from the shards, as `assert_adam_params` holds them (Adam's
  update is about lr x sign(g), so an element whose gradient sits at the
  fp32 noise floor may step the other way in one package). Every rank's
  blocks have `spec_rules.local_shape`, and its state bytes are the sum
  of `spec_rules.local_bytes`. The MoE expert choices of the first
  step's forward are the reference's, token for token (each pod routes
  its rows of the batch).
- **Compression** on (2, 1, 2): `compress.apply` with the layout gives,
  on every rank, exactly its blocks of the whole-tensor round trip over
  two error-feedback rounds; the launcher trains with `--compress-grads`,
  its residuals at the blocks' shapes, the loss finite and falling.
- **Re-meshing.** A (2, 2) run checkpointed after one step restores with
  `shardings` onto (4, 1), and onto a new world of two ranks on (2, 1),
  and both continue bitwise like the uninterrupted (2, 2) run (port
  against port, unrouted: whole activations in one pod take the same
  arithmetic on any mesh; the global norm's fp64 sum does not see the
  blocks). `ft.runtime.elastic_reshard` (2, 2) -> (4, 1) equals that
  restore, block for block.
- **Gathers.** Each gathered parameter is gathered once per use: once
  in a forward (the tied embedding twice: the lookup and the head), and
  in a step once more for the remat recomputation of the stacked layers.
  A read of a sharded weight's shape would gather it too.
- **Failures.** Injected at the same steps on every rank, the loop
  resumes to the clean run's parameters, bitwise. A checkpoint that rank
  0 fails to write raises on both ranks of a world of two, and neither is
  left in a collective.
- **The production meshes.** On the fake 256- and 512-rank worlds (meta
  device, smoke configs), the launcher without `--smoke` shards the state
  on `make_production_mesh`, and rank 0's parameter and AdamW bytes equal
  the dry run's `spec_rules` bytes (`launch.dryrun.placed_bytes`).
- **chip_smoke's sharded phase**, rehearsed on the CPU: its bitwise
  check against the train phase's routed run on a gloo world of one
  rank, its checkpoint, and its host run of four gloo ranks.

This file imports neither jax nor the JAX package.
"""
import dataclasses
import json
import os
import pickle
import subprocess
import sys
import textwrap
import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from test_torch_dist import SRC, finish_reference  # noqa: E402

ARCHS = ("gemma-2b", "deepseek-moe-16b")
MESHES = {"2x2": ((2, 2), ("data", "model")),
          "2x1x2": ((2, 1, 2), ("pod", "data", "model"))}
CASES = [(arch, mesh, routed) for arch in ARCHS for mesh in MESHES
         for routed in (False, True)]
BATCH, SEQ, STEPS, LR = 4, 32, 2, 1e-3
STACKED = ("layers", "dense_layers", "moe_layers")
TIMEOUT_S = 240


def case_key(arch, mesh, routed):
    return f"{arch}/{mesh}/{'routed' if routed else 'unrouted'}"


def ref_key(arch, mesh, routed):
    """The reference's run a port case is held to: the same one, but for
    the routed MoE step, whose reference aborts its XLA CPU runtime about
    half the time (`rendezvous.h` "Id can't be larger than the number of
    participating threads" in an all-reduce over devices [0, 2], or a
    segfault in `block_until_ready`; ROADMAP.md queue 3). The port's
    routed MoE step is held to the reference's unrouted one."""
    return case_key(arch, mesh, routed and arch != "deepseek-moe-16b")


REF_CASES = sorted({ref_key(*c) for c in CASES})


# ---------------------------------------------------------------------------
# the reference, one subprocess per model with four fake host devices
# ---------------------------------------------------------------------------

REFERENCE = textwrap.dedent("""
    import dataclasses, json, os, pickle, sys
    # cheap compiles: the step runs at smoke width, and fast math stays off
    os.environ["XLA_FLAGS"] = ("--xla_force_host_platform_device_count=4 "
                               "--xla_backend_optimization_level=0 "
                               "--xla_llvm_disable_expensive_passes=true")
    import jax
    import jax.numpy as jnp
    import numpy as np
    from jax.sharding import AxisType
    from repro.configs import smoke_config
    from repro.data.pipeline import DataConfig, SyntheticLM
    from repro.deploy import model_workload
    from repro.deploy.warmup import build_planner, warm_buckets
    from repro.models import model, shard_ctx
    from repro.optim import adamw
    from repro.parallel.spec_rules import param_shardings
    from repro.train.steps import make_train_step

    spec = json.load(open(sys.argv[1]))
    arch = sys.argv[2]
    cfg = dataclasses.replace(smoke_config(arch), dtype=jnp.float32)
    params0 = model.init_params(jax.random.PRNGKey(0), cfg)
    path = spec["params"].format(arch=arch)
    with open(path, "wb") as f:
        pickle.dump(jax.tree.map(np.asarray, params0), f)
    open(path + ".done", "w").close()
    data = SyntheticLM(DataConfig(vocab=cfg.vocab, seq_len=spec["seq"],
                                  global_batch=spec["batch"]))
    batches = [{k: jnp.asarray(v) for k, v in data.batch(i).items()}
               for i in range(spec["steps"])]
    opt = adamw.AdamWConfig(lr=spec["lr"], warmup_steps=5,
                            total_steps=spec["steps"])
    n_moe = cfg.n_layers - cfg.n_dense_layers if cfg.n_experts else 0
    seen = []
    real_top_k = jax.lax.top_k

    def top_k(gates, k):
        out = real_top_k(gates, k)
        jax.debug.callback(lambda i: seen.append(np.array(i)), out[1])
        return out
    jax.lax.top_k = top_k

    out = {}
    for name, (shape, axes) in spec["meshes"].items():
        mesh = jax.make_mesh(tuple(shape), tuple(axes),
                             axis_types=(AxisType.Auto,) * len(shape))
        shard_ctx.set_mesh(mesh)
        dp = 1
        for a in ("pod", "data"):
            if a in mesh.axis_names:
                dp *= mesh.shape[a]
        # the routed MoE step aborts the reference's XLA CPU runtime about
        # half the time (ROADMAP.md queue 3): it runs unrouted only
        for routed in (False,) if cfg.n_experts else (False, True):
            key = "%s/%s/%s" % (arch, name,
                                "routed" if routed else "unrouted")
            ctx = None
            if routed:
                planner = build_planner("/".join(
                    (spec["ref_plans"], arch, name)), (4, 4), 12)
                workload = model_workload(cfg, spec["batch"], spec["seq"],
                                          kind="train", dp=dp)
                warm_buckets(planner, workload)
                planner.batch_tune(workload, allow_bucketed=True)
                ctx = shard_ctx.GemmContext(mesh=mesh, planner=planner)
            shard_ctx.set_gemm_context(ctx)
            shardings = param_shardings(jax.eval_shape(lambda: params0),
                                        mesh)
            p = jax.tree.map(jax.device_put, params0, shardings)
            o = adamw.init(p)
            step = jax.jit(make_train_step(cfg, opt))
            losses, norms = [], []
            for i, b in enumerate(batches):
                del seen[:]
                p, o, _, m = step(p, o, None, b)
                jax.block_until_ready(p)
                losses.append(float(m["loss"]))
                norms.append(float(m["grad_norm"]))
                if i == 0:
                    # the forward routes each MoE layer in order first (its
                    # remat recomputation routes them again, identically)
                    for j, c in enumerate(seen[:n_moe]):
                        out[key + "/choices/%d" % j] = c
            out[key + "/loss"] = np.array(losses)
            out[key + "/grad_norm"] = np.array(norms)
            out[key + "/lr"] = np.array(float(m["lr"]))
            with open(spec["ref_params"].format(
                    key=key.replace("/", "_")), "wb") as f:
                pickle.dump(jax.tree.map(np.asarray, p), f)
            shard_ctx.set_gemm_context(None)
    np.savez(spec["ref_out"].format(arch=arch), **out)
    print("REFERENCE_OK")
""")


# ---------------------------------------------------------------------------
# the production meshes on the fake worlds, in one subprocess
# ---------------------------------------------------------------------------

PRODUCTION = textwrap.dedent("""
    import json, sys
    import torch
    import torch.distributed as dist
    from repro_torch.configs import smoke_config
    from repro_torch.launch import dryrun, train
    from repro_torch.launch.input_specs import param_shapes
    from repro_torch.models import shard_ctx
    from repro_torch.models.model import make_trainable
    from repro_torch.optim import adamw
    from repro_torch.parallel import sharded, spec_rules

    out = {}
    for multi_pod in (False, True):
        world = dryrun.init_fake_world(multi_pod)
        for arch in sys.argv[2:]:
            cfg = smoke_config(arch)
            args = train.parse_args(["--arch", arch, "--device", "meta",
                                     "--skip-plan-warmup"]
                                    + (["--multi-pod"] if multi_pod else []))
            s = train.setup(args, cfg=cfg)
            params, opt, _ = s.init_state()
            layout = sharded.layout_of(params)
            shapes_ok = all(
                tuple(p.shape) == spec_rules.local_shape(
                    layout.placements[n].shape, layout.placements[n].spec,
                    s.mesh)
                for n, p in params.named_parameters())
            nbytes = lambda ts: sum(t.numel() * t.element_size() for t in ts)
            whole = make_trainable(param_shapes(cfg))
            whole_opt = adamw.init(whole)
            out["%s/%d" % (arch, world)] = {
                "mesh": dict(s.mesh.shape), "rank": s.mesh.rank,
                "shapes_ok": shapes_ok,
                "params": nbytes(params.parameters()),
                "opt": nbytes(list(opt.mu.values())
                              + list(opt.nu.values())),
                "dryrun_params": dryrun.placed_bytes(
                    dryrun._params_placed(whole, s.mesh), s.mesh),
                "dryrun_opt": dryrun.placed_bytes(
                    dryrun._dict_placed(whole_opt.mu, s.mesh)
                    + dryrun._dict_placed(whole_opt.nu, s.mesh), s.mesh),
                "whole_params": nbytes(whole.parameters())}
        shard_ctx.set_mesh(None)
        dist.destroy_process_group()
    json.dump(out, open(sys.argv[1], "w"))
    print("PRODUCTION_OK")
""")


# ---------------------------------------------------------------------------
# the port, in four (then two) gloo processes
# ---------------------------------------------------------------------------

def _wait(path):
    deadline = time.monotonic() + TIMEOUT_S
    while not os.path.exists(path + ".done"):
        if time.monotonic() > deadline:
            raise TimeoutError(f"the reference wrote no {path}")
        time.sleep(0.2)


def _cfg(arch):
    from repro_torch.configs import smoke_config
    return dataclasses.replace(smoke_config(arch), dtype=torch.float32)


def _args(spec, arch, extra=()):
    """The launcher's flags; each rank warms its own plan cache (the
    tuner is deterministic, so every rank resolves the same plans)."""
    import torch.distributed as dist
    from repro_torch.launch import train
    return train.parse_args(["--arch", arch, "--device", "cpu",
                             "--batch", str(BATCH), "--seq", str(SEQ),
                             "--steps", str(spec["steps"]),
                             "--lr", str(LR), "--plan-cache",
                             spec["port_plans"].format(
                                 rank=dist.get_rank())] + list(extra))


def _whole(params):
    """name -> the whole parameter (numpy), gathered from the blocks."""
    from repro_torch.parallel import sharded
    layout = sharded.layout_of(params)
    return {n: sharded.gather_data(p, layout.placements[n]).numpy().copy()
            for n, p in params.named_parameters()}


def _local_ok(state, mesh):
    """Every block of the state at `spec_rules.local_shape`, and the state's
    bytes the sum of `spec_rules.local_bytes` of its whole tensors."""
    from repro_torch.ckpt.manager import flatten
    from repro_torch.parallel import sharded, spec_rules
    placed = sharded.state_shardings(state)
    got = want = 0
    for name, t in flatten(state):
        pl = placed.get(name)
        if pl is None:
            continue
        if tuple(t.shape) != spec_rules.local_shape(pl.shape, pl.spec, mesh):
            return False
        got += t.numel() * t.element_size()
        want += spec_rules.local_bytes(torch.empty(pl.shape, dtype=t.dtype,
                                                   device="meta"),
                                       pl.spec, mesh)
    n_params = len(sharded.layout_of(state[0]).placements)
    return got == want and len(placed) >= 3 * n_params


def _parity_case(spec, rank, mesh, arch, routed, out):
    """Two steps of the sharded launcher step from the reference's
    weights; the first step's expert choices recorded."""
    from repro_torch.launch import train
    from repro_torch.models import model as tmodel
    from repro_torch.models import moe as tmoe
    from repro_torch.models import shard_ctx
    from repro_torch.optim import adamw
    from repro_torch.parallel import sharded
    cfg = _cfg(arch)
    key = case_key(arch, mesh["name"], routed)
    s = train.setup(_args(spec, arch, () if routed else
                          ("--skip-plan-warmup",)), cfg=cfg,
                    mesh=mesh["mesh"])
    with open(spec["params"].format(arch=arch), "rb") as f:
        params = tmodel.make_trainable(tmodel.params_from_numpy(
            pickle.load(f), cfg, device="cpu"))
    sharded.shard_params(params, mesh["mesh"])
    state = (params, adamw.init(params), None)
    n_moe = cfg.n_layers - cfg.n_dense_layers if cfg.n_experts else 0
    choices = []
    real_route = tmoe.route

    def route(p, xt, c):
        topv, topi = real_route(p, xt, c)
        if len(choices) < n_moe:
            choices.append(topi.numpy().copy())
        return topv, topi
    tmoe.route = route
    losses, norms = [], []
    try:
        for i in range(spec["steps"]):
            state, m = s.step_fn(state, s.batch_arrays(s.data.batch(i)))
            losses.append(float(m["loss"]))
            norms.append(float(m["grad_norm"]))
    finally:
        tmoe.route = real_route
        shard_ctx.set_gemm_context(None)
    out[key + "/loss"] = np.array(losses)
    out[key + "/grad_norm"] = np.array(norms)
    out[key + "/local_ok"] = np.array(_local_ok(state, mesh["mesh"]))
    out[key + "/pod"] = np.array(mesh["mesh"].coord("pod")
                                 if "pod" in mesh["mesh"].shape else 0)
    for j, c in enumerate(choices):
        out[key + f"/choices/{j}"] = c
    if routed:
        st = s.gemm_ctx.stats
        out[key + "/resolve_rate"] = np.array(st.resolve_rate)
        out[key + "/executed"] = np.array(st.executed_gemm)
    for name, w in _whole(params).items():
        out[key + "/params/" + name] = w


def _compress_case(spec, rank, mesh, out):
    """compress.apply on blocks against the whole-tensor round trip, and
    the launcher with --compress-grads on the pod mesh."""
    from repro_torch.launch import train
    from repro_torch.models import model as tmodel
    from repro_torch.optim import compress
    from repro_torch.parallel import sharded
    cfg = _cfg("gemma-2b")
    params = sharded.shard_params(tmodel.make_trainable(tmodel.init_params(
        torch.Generator().manual_seed(0), cfg, "cpu")), mesh)
    layout = sharded.layout_of(params)
    gen = torch.Generator().manual_seed(7)        # the same on every rank
    whole_state = compress.init({n: torch.zeros(pl.shape) for n, pl
                                 in layout.placements.items()})
    state = compress.init(params)
    exact = True
    for _ in range(2):
        grads = {n: torch.randn(pl.shape, generator=gen)
                 for n, pl in layout.placements.items()}
        want, whole_state = compress.apply(grads, whole_state)
        got, state = compress.apply(
            {n: grads[n][layout.placements[n].block()].clone()
             for n in grads}, state, layout)
        for n, pl in layout.placements.items():
            exact &= torch.equal(got[n], want[n][pl.block()])
            exact &= torch.equal(state.residual[n],
                                 whole_state.residual[n][pl.block()])
    out["compress/exact"] = np.array(exact)
    s = train.setup(_args(spec, "gemma-2b", ("--skip-plan-warmup",
                                             "--compress-grads")),
                    cfg=cfg, mesh=mesh)
    st = s.init_state()
    losses = []
    for i in range(spec["steps"] + 1):
        st, m = s.step_fn(st, s.batch_arrays(s.data.batch(0)))
        losses.append(float(m["loss"]))
    out["compress/loss"] = np.array(losses)
    out["compress/local_ok"] = np.array(_local_ok(st, mesh))
    out["compress/residual_nonzero"] = np.array(
        all(bool(r.abs().sum() > 0) for r in st[2].residual.values()))


def _unrouted(spec, arch="gemma-2b", extra=()):
    return _args(spec, arch, ("--skip-plan-warmup",) + tuple(extra))


def _gather_case(spec, rank, mesh, arch, out):
    """The gathers of each gathered parameter in a no-grad loss and in one
    launcher step, counted at `sharded.gather`."""
    from repro_torch.launch import train
    from repro_torch.parallel import sharded
    from repro_torch.train import steps
    cfg = _cfg(arch)
    s = train.setup(_unrouted(spec, arch), cfg=cfg, mesh=mesh)
    state = s.init_state()
    layout = sharded.layout_of(state[0])
    gathered = {id(pl): n for n, pl in layout.placements.items()
                if len(pl.gather_ranks) > 1}
    counts = dict.fromkeys(gathered.values(), 0)
    real = sharded.gather

    def gather(block, pl):
        counts[gathered[id(pl)]] += 1
        return real(block, pl)
    sharded.gather = gather
    try:
        batch = s.batch_arrays(s.data.batch(0))
        with torch.no_grad():
            steps.loss_fn(state[0], batch, cfg)
        forward = dict(counts)
        counts.update(dict.fromkeys(counts, 0))
        s.step_fn(state, batch)
    finally:
        sharded.gather = real
    for n in counts:
        out[f"gathers/{arch}/{n}"] = np.array([forward[n], counts[n]])
    out[f"gathers/{arch}/tied"] = np.array(cfg.tie_embeddings)


def _continue(s, state, first, last):
    losses = []
    for i in range(first, last):
        state, m = s.step_fn(state, s.batch_arrays(s.data.batch(i)))
        losses.append(float(m["loss"]))
    return state, losses


def _remesh_case(spec, rank, meshes, out):
    """Uninterrupted on (2, 2); checkpointed after one step; restored and
    re-sharded onto (4, 1)."""
    from repro_torch.ckpt.manager import CheckpointManager, flatten
    from repro_torch.ft import runtime
    from repro_torch.launch import train
    from repro_torch.parallel import sharded
    cfg = _cfg("gemma-2b")
    total = 1 + spec["resume_steps"]
    s = train.setup(_unrouted(spec), cfg=cfg, mesh=meshes["2x2"])
    state, losses = _continue(s, s.init_state(), 0, total)
    out["remesh/clean_loss"] = np.array(losses)
    clean = _whole(state[0])
    if rank == 0:
        np.savez(spec["clean"], **clean)
    state, _ = _continue(s, s.init_state(), 0, 1)
    mgr = CheckpointManager(spec["ckpt"])
    mgr.save(0, state, shardings=sharded.state_shardings(state))
    moved = runtime.elastic_reshard(state, meshes["4x1"])

    s41 = train.setup(_unrouted(spec), cfg=cfg, mesh=meshes["4x1"])
    like = s41.init_state()
    restored = mgr.restore(0, like, sharded.state_shardings(like))
    out["remesh/elastic_equal"] = np.array(all(
        torch.equal(a, b) and na == nb for (na, a), (nb, b)
        in zip(flatten(moved), flatten(restored))))
    restored, losses = _continue(s41, restored, 1, total)
    out["remesh/4x1_loss"] = np.array(losses)
    out["remesh/4x1_equal"] = np.array(all(
        np.array_equal(w, clean[n]) for n, w in _whole(restored[0]).items()))


def _failure_case(spec, rank, mesh, out):
    """The loop with failures at steps 1 and 3 on every rank against a
    clean loop."""
    from repro_torch.ft.runtime import FailureInjector
    from repro_torch.launch import train
    cfg = _cfg("gemma-2b")
    finals = {}
    for name, fail_at in (("clean", ()), ("faulty", {1, 3})):
        args = _unrouted(spec, extra=(
            "--steps", "5", "--ckpt-every", "2",
            "--ckpt-dir", spec["loop_ckpt"].format(name=name)))
        s = train.setup(args, cfg=cfg, mesh=mesh)
        inj = FailureInjector(fail_at=fail_at)
        state = train.run(s, injector=inj)
        finals[name] = _whole(state[0])
        out[f"failure/{name}_failed"] = np.array(sorted(inj.failed))
    out["failure/equal"] = np.array(all(
        np.array_equal(finals["faulty"][n], w)
        for n, w in finals["clean"].items()))


def _init(rank, world, store_path):
    import torch.distributed as dist
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"file://{store_path}",
                            rank=rank, world_size=world)
    return dist


def _worker(rank, store_path, spec_path):
    dist = _init(rank, 4, store_path)
    from repro_torch.launch.mesh import make_dist_mesh
    try:
        spec = json.load(open(spec_path))
        meshes = {name: make_dist_mesh(shape, "cpu", axes)
                  for name, (shape, axes) in MESHES.items()}
        meshes["4x1"] = make_dist_mesh((4, 1), "cpu")
        out = {}
        _compress_case(spec, rank, meshes["2x1x2"], out)
        _remesh_case(spec, rank, meshes, out)
        _failure_case(spec, rank, meshes["2x2"], out)
        for arch in ARCHS:
            _gather_case(spec, rank, meshes["2x2"], arch, out)
        for arch in ARCHS:
            _wait(spec["params"].format(arch=arch))
            for name in MESHES:
                for routed in (False, True):
                    _parity_case(spec, rank,
                                 {"name": name, "mesh": meshes[name]},
                                 arch, routed, out)
        np.savez(spec["port_out"].format(rank=rank), **out)
    finally:
        dist.destroy_process_group()


def _world2_worker(rank, store_path, spec_path):
    """A new world of two ranks restores the (2, 2) checkpoint on (2, 1)
    and continues."""
    dist = _init(rank, 2, store_path)
    from repro_torch.ckpt.manager import CheckpointManager
    from repro_torch.launch import train
    from repro_torch.launch.mesh import make_dist_mesh
    from repro_torch.parallel import sharded
    try:
        spec = json.load(open(spec_path))
        s = train.setup(_unrouted(spec), cfg=_cfg("gemma-2b"),
                        mesh=make_dist_mesh((2, 1), "cpu"))
        like = s.init_state()
        state = CheckpointManager(spec["ckpt"]).restore(
            0, like, sharded.state_shardings(like))
        state, losses = _continue(s, state, 1, 1 + spec["resume_steps"])
        clean = dict(np.load(spec["clean"]))
        out = {"loss": np.array(losses), "equal": np.array(all(
            np.array_equal(w, clean[n])
            for n, w in _whole(state[0]).items()))}
        out["save_failure"] = np.array(_save_failure(spec, rank, s))
        np.savez(spec["world2_out"].format(rank=rank), **out)
    finally:
        dist.destroy_process_group()


def _save_failure(spec, rank, s):
    """The loop checkpointing every step while rank 0's writes fail (its
    `np.savez` raises): the error each rank ends with, or ''."""
    from repro_torch.ft.runtime import LoopConfig, run_training
    real = np.savez

    def broken(*args, **kwargs):
        raise OSError("no space left on device")
    if rank == 0:
        np.savez = broken
    try:
        run_training(s.step_fn, s.init_state, s.data,
                     LoopConfig(total_steps=2, ckpt_every=1,
                                ckpt_dir=spec["failed_ckpt"],
                                max_restarts=1, host=rank),
                     make_batch_arrays=s.batch_arrays)
        return ""
    except Exception as err:
        return f"{type(err).__name__}: {err}"
    finally:
        np.savez = real


def spawn_ranks(target, world, args, timeout=TIMEOUT_S):
    """tests/test_torch_dist.py's `run_ranks` for a world of `world`:
    spawn `target(rank, *args)` per rank, join within the timeout, kill
    what is left, and fail on any exit code."""
    ctx = torch.multiprocessing.get_context("spawn")
    procs = [ctx.Process(target=target, args=(r, *args))
             for r in range(world)]
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
    assert codes == [0] * world, f"rank exit codes {codes}"


def _start(body, *argv):
    env = dict(os.environ)
    env["PYTHONPATH"] = SRC + os.pathsep + env.get("PYTHONPATH", "")
    env.pop("XLA_FLAGS", None)
    env["JAX_PLATFORMS"] = "cpu"
    return subprocess.Popen([sys.executable, "-c", body, *argv], env=env,
                            stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                            text=True)


def _port_named(tree):
    """The reference's parameter tree under the port's names: block i of
    a stacked group G is `G.i.<path>`."""
    from repro_torch.models.model import _flatten
    out = {}
    for name, leaf in _flatten(tree):
        group, _, rest = name.partition(".")
        if group in STACKED:
            for i in range(len(leaf)):
                out[f"{group}.{i}.{rest}"] = np.asarray(leaf[i], np.float32)
        else:
            out[name] = np.asarray(leaf, np.float32)
    return out


@pytest.fixture(scope="module")
def sharded_run(tmp_path_factory):
    """Both references, the production meshes and the four ranks at once;
    then the world of two."""
    tmp = tmp_path_factory.mktemp("sharded_train")
    spec = {"batch": BATCH, "seq": SEQ, "steps": STEPS, "lr": LR,
            "resume_steps": 2,
            "meshes": {k: [list(v[0]), list(v[1])]
                       for k, v in MESHES.items()},
            "params": str(tmp / "params_{arch}.pkl"),
            "ref_out": str(tmp / "ref_{arch}.npz"),
            "ref_params": str(tmp / "ref_params_{key}.pkl"),
            "ref_plans": str(tmp / "ref_plans"),
            "port_plans": str(tmp / "port_plans{rank}"),
            "port_out": str(tmp / "port{rank}.npz"),
            "world2_out": str(tmp / "world2_{rank}.npz"),
            "clean": str(tmp / "clean.npz"),
            "ckpt": str(tmp / "ckpt"),
            "loop_ckpt": str(tmp / "loop_{name}"),
            "failed_ckpt": str(tmp / "failed_ckpt")}
    spec_path = tmp / "spec.json"
    spec_path.write_text(json.dumps(spec))
    refs = [_start(REFERENCE, str(spec_path), arch) for arch in ARCHS]
    prod_out = tmp / "production.json"
    prod = _start(PRODUCTION, str(prod_out), *ARCHS)
    try:
        spawn_ranks(_worker, 4, (str(tmp / "store"), str(spec_path)))
        spawn_ranks(_world2_worker, 2, (str(tmp / "store2"),
                                        str(spec_path)))
    finally:
        for proc in refs:
            finish_reference(proc, "REFERENCE_OK")
        finish_reference(prod, "PRODUCTION_OK")
    ref = {}
    for arch in ARCHS:
        ref.update(dict(np.load(spec["ref_out"].format(arch=arch))))
    for key in REF_CASES:
        with open(spec["ref_params"].format(key=key.replace("/", "_")),
                  "rb") as f:
            ref[key + "/params"] = _port_named(pickle.load(f))
    old = {}
    for arch in ARCHS:
        with open(spec["params"].format(arch=arch), "rb") as f:
            old[arch] = _port_named(pickle.load(f))
    ports = [dict(np.load(spec["port_out"].format(rank=r)))
             for r in range(4)]
    world2 = [dict(np.load(spec["world2_out"].format(rank=r)))
              for r in range(2)]
    return {"ref": ref, "old": old, "ports": ports, "world2": world2,
            "production": json.loads(prod_out.read_text())}


# ---------------------------------------------------------------------------
# the cases
# ---------------------------------------------------------------------------

def assert_adam_params(old, new_t, new_j, lr_sum, wd=0.01):
    """Parameters (numpy, by name) after a few Adam steps in the port (t)
    and the reference (j) from the same `old` values. Adam's update is
    about lr x sign(g), so an element whose gradient sits at the fp32
    noise floor may step the other way in one package: such elements must
    be at most 1 % of each tensor's (none in a tensor of under 100), and
    every element of both packages within the steps' reach, 3 x lr_sum x
    (1 + wd |p|), of where it started; every other element within
    PARAM_ATOL of the reference's (1 % of the two steps' lr_sum = 1e-3;
    measured: at most 10 of 170,432 (gemma-2b) or 298,432
    (deepseek-moe-16b) elements apart by more than 1e-6, the worst by
    1.6e-5). An unchanged or sign-flipped update of any one tensor, however
    small, fails on nearly every element of it."""
    crowded = {}
    for k, p0 in old.items():
        err = np.abs(new_t[k] - new_j[k])
        reach = 3 * lr_sum * (1 + wd * np.abs(p0)) + 1e-7
        for new in (new_t[k], new_j[k]):
            assert (np.abs(new - p0) <= reach).all(), k
        apart = int((err > PARAM_ATOL).sum())
        if apart > 0.01 * p0.size:
            crowded[k] = (apart, p0.size)
    assert not crowded, crowded


PARAM_ATOL = 1e-5


def _rel(got, want):
    return np.abs(np.asarray(got) - np.asarray(want)) / np.abs(want)


@pytest.mark.parametrize("arch,mesh,routed", CASES,
                         ids=[case_key(*c).replace("/", "-") for c in CASES])
def test_sharded_step_matches_reference(sharded_run, arch, mesh, routed):
    ref, ports = sharded_run["ref"], sharded_run["ports"]
    key, rkey = case_key(arch, mesh, routed), ref_key(arch, mesh, routed)
    old = sharded_run["old"][arch]
    lr_sum = float(np.sum([LR * min(1.0, (i + 1) / 5)
                           for i in range(1, STEPS + 1)]))
    for port in ports:
        assert (_rel(port[key + "/loss"], ref[rkey + "/loss"])
                <= 1e-5).all()
        assert (_rel(port[key + "/grad_norm"], ref[rkey + "/grad_norm"])
                <= 1e-4).all()
        assert bool(port[key + "/local_ok"])
        if routed:
            assert float(port[key + "/resolve_rate"]) == 1.0
            assert int(port[key + "/executed"]) > 0
        new_t = {n: port[key + "/params/" + n] for n in old}
        assert_adam_params(old, new_t, ref[rkey + "/params"], lr_sum)
        for n in old:
            np.testing.assert_array_equal(new_t[n],
                                          ports[0][key + "/params/" + n])


MOE_CASES = [c for c in CASES if c[0] == "deepseek-moe-16b"]


@pytest.mark.parametrize("arch,mesh,routed", MOE_CASES,
                         ids=[case_key(*c).replace("/", "-")
                              for c in MOE_CASES])
def test_moe_expert_choices_match_reference(sharded_run, arch, mesh,
                                            routed):
    """Each rank routes its pod's rows of the batch: its choices are its
    pod's share of the reference's, token for token, in every MoE
    layer."""
    ref, ports = sharded_run["ref"], sharded_run["ports"]
    key, rkey = case_key(arch, mesh, routed), ref_key(arch, mesh, routed)
    layers = sorted(k[len(rkey):] for k in ref
                    if k.startswith(rkey + "/choices/"))
    assert layers
    pods = MESHES[mesh][0][0] if len(MESHES[mesh][0]) == 3 else 1
    for port in ports:
        pod = int(port[key + "/pod"])
        for k in layers:
            want = ref[rkey + k].reshape(-1, ref[rkey + k].shape[-1])
            n = want.shape[0] // pods
            got = port[key + k].reshape(-1, port[key + k].shape[-1])
            np.testing.assert_array_equal(got, want[pod * n:(pod + 1) * n])


def test_compress_grads_on_the_pod_mesh(sharded_run):
    for port in sharded_run["ports"]:
        assert bool(port["compress/exact"])
        assert bool(port["compress/local_ok"])
        assert bool(port["compress/residual_nonzero"])
        losses = port["compress/loss"]
        assert np.isfinite(losses).all() and losses[-1] < losses[0]


def test_restore_onto_other_meshes_continues_bitwise(sharded_run):
    ports, world2 = sharded_run["ports"], sharded_run["world2"]
    for port in ports:
        clean = port["remesh/clean_loss"]
        np.testing.assert_array_equal(port["remesh/4x1_loss"], clean[1:])
        assert bool(port["remesh/4x1_equal"])
    for port in world2:
        np.testing.assert_array_equal(port["loss"],
                                      ports[0]["remesh/clean_loss"][1:])
        assert bool(port["equal"])


def test_elastic_reshard_equals_restore(sharded_run):
    for port in sharded_run["ports"]:
        assert bool(port["remesh/elastic_equal"])


def test_failure_at_the_same_step_on_every_rank_resumes(sharded_run):
    for port in sharded_run["ports"]:
        assert list(port["failure/faulty_failed"]) == [1, 3]
        assert bool(port["failure/equal"])


def test_a_failed_checkpoint_write_raises_on_every_rank(sharded_run):
    """Rank 0's write fails at every save: both ranks restart together
    and, past `max_restarts`, both raise (a hang would leave the world
    of two past its timeout in `spawn_ranks`)."""
    rank0, rank1 = (str(p["save_failure"]) for p in sharded_run["world2"])
    assert rank0 == "OSError: no space left on device"
    assert rank1 == "RuntimeError: rank 0 failed to write checkpoint step 0"


def test_param_check_catches_one_unchanged_small_tensor(sharded_run):
    """`assert_adam_params` on a fault confined to the model's smallest
    tensor: the port's (2, 2) gemma-2b parameters pass as they are, and
    fail with that tensor left where it started."""
    key = case_key("gemma-2b", "2x2", False)
    old = sharded_run["old"]["gemma-2b"]
    ref = sharded_run["ref"][key + "/params"]
    new_t = {n: sharded_run["ports"][1][key + "/params/" + n] for n in old}
    lr_sum = float(np.sum([LR * min(1.0, (i + 1) / 5)
                           for i in range(1, STEPS + 1)]))
    assert_adam_params(old, new_t, ref, lr_sum)
    small = min(old, key=lambda n: old[n].size)
    new_t[small] = old[small].copy()
    with pytest.raises(AssertionError, match=small):
        assert_adam_params(old, new_t, ref, lr_sum)


@pytest.mark.parametrize("arch", ARCHS)
def test_one_gather_per_weight_use(sharded_run, arch):
    """On (2, 2) a gathered parameter is gathered once per read in a
    no-grad loss (the tied embedding twice: lookup and head, every other
    once), and in a step once more where the remat recomputation reads it
    again (the stacked layers')."""
    for port in sharded_run["ports"]:
        prefix = f"gathers/{arch}/"
        tied = bool(port[prefix + "tied"])
        counts = {k[len(prefix):]: port[k] for k in port
                  if k.startswith(prefix) and k != prefix + "tied"}
        assert counts
        for name, (forward, step) in counts.items():
            uses = 2 if tied and name == "embed" else 1
            remat = 2 if name.split(".")[0] in STACKED else 1
            assert (forward, step) == (uses, uses * remat), name


PRODUCTION_CASES = [(arch, world) for world in (256, 512) for arch in ARCHS]


@pytest.mark.parametrize("arch,world", PRODUCTION_CASES,
                         ids=[f"{a}-{w}" for a, w in PRODUCTION_CASES])
def test_production_mesh_state_bytes_match_the_dry_run(sharded_run, arch,
                                                       world):
    rec = sharded_run["production"][f"{arch}/{world}"]
    assert rec["rank"] == 0 and rec["shapes_ok"]
    assert rec["mesh"] == ({"data": 16, "model": 16} if world == 256 else
                           {"pod": 2, "data": 16, "model": 16})
    assert rec["params"] == rec["dryrun_params"] < rec["whole_params"]
    assert rec["opt"] == rec["dryrun_opt"]


def test_chip_smoke_sharded_phase_rehearsed_on_cpu(monkeypatch, tmp_path,
                                                   capsys):
    """`chip_smoke.sharded_train` on the CPU at smoke width (bf16): the
    train phase's routed run (`train_model(keep=...)`, with the verify
    skill's stubs: `ops.mmad` counted, the tensor-core backward taken for
    bf16 operands, the profile stubbed), then the same steps sharded on a
    1x1 mesh over a gloo world of one rank, which must equal it bitwise
    with as many `mmad` calls a step; the smoke-width checkpoint and
    `elastic_reshard`; and the host's four gloo ranks against the
    unsharded step."""
    import importlib
    from repro_torch.kernels import ops
    from repro_torch.models import shard_ctx
    from repro_torch.obs import set_tracer
    monkeypatch.syspath_prepend(os.path.join(SRC, ".."))
    chip_smoke = importlib.import_module("chip_smoke")
    mmad_mod = importlib.import_module("repro_torch.kernels.mmad")
    real = ops.mmad

    def counted(a, b, *args, **kw):
        mmad_mod._launches += 1
        return real(a, b, *args, **kw)
    monkeypatch.setattr(ops, "mmad", counted)
    monkeypatch.setattr(ops, "tensor_core_backward",
                        lambda a, b: a.dtype == b.dtype == torch.bfloat16)
    monkeypatch.setattr(chip_smoke, "train_profile", lambda *a, **k: {
        "busy_ms": 1, "wall_ms": 1, "mmad_ms": 0})
    monkeypatch.setattr(chip_smoke, "ROOT", tmp_path)
    args = ["--arch", "gemma-2b", "--smoke", "--device", "cpu", "--batch",
            "2", "--seq", "64"]
    routed = {}
    try:
        per_step = chip_smoke.train_model(torch, mmad_mod,
                                          torch.device("cpu"), args,
                                          keep=routed)[0]
        assert routed["per_step"] == per_step > 0
        summary = chip_smoke.sharded_train(torch, mmad_mod,
                                           torch.device("cpu"), routed, args)
    finally:
        shard_ctx.set_gemm_context(None)
        shard_ctx.set_mesh(None)
        set_tracer(None)
    out = capsys.readouterr().out
    assert summary["per_step"] == per_step
    assert "0 of" in out and "differ from its final ones" in out
    assert "sharded checkpoint at smoke width" in out
    assert set(summary["host"]) == {f"{m}/{r}" for m in MESHES
                                    for r in (False, True)}
