"""Multi-pod dry-run launcher (the §Roofline data source).

Port of `repro/launch/dryrun.py`. For one (arch x shape x mesh) cell:

1. FULL config: one call of the cell's step at full configuration, every
   tensor on the meta device (shapes and dtypes, no memory, nothing on a
   card), over a fake `torch.distributed` world of 256 (or 512) ranks that
   carries the 16x16 (or 2x16x16) production mesh. The call proves the
   step runs end to end at that size; the per-device argument and output
   bytes come from the parameter, optimizer, batch and cache specs of
   `parallel/spec_rules.py` (`local_shape`), which is what XLA's
   `memory_analysis()` counts for the reference's partitioned arguments.
   The eager step is not partitioned, so there is no temp-buffer count
   (`temp_bytes_per_device` is null, with a note).
2. ACCOUNTING configs (1 and 2 layer units, under `accounting_mode`):
   FLOPs (`torch.utils.flop_counter.FlopCounterMode`), bytes (every aten
   op's tensor inputs and outputs, views excluded: unfused, so above XLA's
   fused count) and collective bytes (`hlo_stats.record_collectives`),
   extrapolated linearly to the full depth as the reference does. Eager
   tracing counts every loop iteration, so the sLSTM time loop needs no
   analytic correction.

The process initialises the fake world itself (as rank 0), so run each
cell in its own process: the sweep does. A record-only cell traces the
whole, unsharded step (`scope: global`): nothing is multiplied by the
chip count, and it calls no collective. A `--route` cell dispatches every
model matmul through its tuned dataflow's mode body on the production
mesh, running rank 0's share and counting its collectives
(`scope: rank 0`).

Each invocation handles one cell and writes JSON to --out (crash
isolation; the sweep script loops and caches).

Usage:
  python -m repro_torch.launch.dryrun --arch qwen3-14b --shape train_4k \\
      [--multi-pod] [--skip-accounting] --out results/dryrun

With --plan-cache the cell also cross-validates the deployment-plan
workload (record-only). Adding --route runs the cell with plan routing
ON: every model matmul dispatches through its tuned dataflow's
collectives on the 16x16 production mesh and the JSON reports per-reason
lowering fallbacks (pair with --skip-accounting to keep the measurement
to the one routed trace). --route-dataflows restricts the warm-up's
candidate search, e.g. `--route-dataflows systolic_over_summa`.
--calibrate closes the measurement loop first: every executable mode runs
on a --plan-grid mesh of R*C worker processes (NCCL, one a card, or gloo
CPU processes with --calibrate-device cpu), a CalibrationProfile is
fitted and persisted into --plan-cache, the warm-up tunes with the
measured cost model, and the JSON gains a 'calibration' section.

With --plan-cache the cell additionally installs the structured dispatch
tracer (repro_torch.obs) and writes, next to the cell JSON:
<tag>.run_report.json (routing counters, per-dispatch plan provenance,
workload coverage, calibration fit, predicted-vs-measured drift) and
<tag>.trace.json (Chrome trace-event spans, loadable at ui.perfetto.dev).
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import os
import tempfile
import time
import traceback
from typing import Any, Callable, Dict, List, Optional, Tuple

import torch
from torch.utils._python_dispatch import TorchDispatchMode

from repro_torch.configs import SHAPES, get_config
from repro_torch.hw.config import H100_SXM
from repro_torch.launch import flops as flops_lib
from repro_torch.launch.hlo_stats import record_collectives
from repro_torch.launch.input_specs import input_specs, param_shapes
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.models import accounting, shard_ctx
from repro_torch.models.common import ModelConfig
from repro_torch.models.model import (decode_step, forward, lm_head_weight,
                                      make_trainable)
from repro_torch.optim import adamw
from repro_torch.parallel.spec_rules import (batch_spec, cache_leaves,
                                             cache_shardings, dp_axes,
                                             local_bytes, param_shardings)
from repro_torch.train.steps import make_train_step


# ---------------------------------------------------------------------------
# accounting-unit reduction per arch family
# ---------------------------------------------------------------------------

def accounting_configs(cfg: ModelConfig) -> Tuple[ModelConfig, ModelConfig,
                                                  float, int, int]:
    """(cfg_small, cfg_big, units_full, units_small, units_big): linear
    extrapolation F_full = F_s + (units_full - u_s)/(u_b - u_s) * (F_b - F_s)."""
    if cfg.is_encoder_decoder:
        c1 = dataclasses.replace(cfg, n_layers=1, n_encoder_layers=1)
        c2 = dataclasses.replace(cfg, n_layers=2, n_encoder_layers=2)
        return c1, c2, cfg.n_layers, 1, 2
    if cfg.block_pattern == "mamba2_hybrid":
        per = cfg.hybrid_attn_every
        c1 = dataclasses.replace(cfg, n_layers=per)
        c2 = dataclasses.replace(cfg, n_layers=2 * per)
        return c1, c2, cfg.n_layers / per, 1, 2
    if cfg.block_pattern == "xlstm":
        per = cfg.slstm_every
        c1 = dataclasses.replace(cfg, n_layers=per)
        c2 = dataclasses.replace(cfg, n_layers=2 * per)
        return c1, c2, cfg.n_layers // per, 1, 2
    if cfg.n_experts and cfg.n_dense_layers:
        # keep the dense layer in the base; delta = one MoE layer
        c1 = dataclasses.replace(cfg, n_layers=cfg.n_dense_layers + 1)
        c2 = dataclasses.replace(cfg, n_layers=cfg.n_dense_layers + 2)
        return c1, c2, cfg.n_layers - cfg.n_dense_layers, 1, 2
    c1 = dataclasses.replace(cfg, n_layers=1)
    c2 = dataclasses.replace(cfg, n_layers=2)
    return c1, c2, cfg.n_layers, 1, 2


# ---------------------------------------------------------------------------
# the fake world
# ---------------------------------------------------------------------------

def init_fake_world(multi_pod: bool) -> int:
    """Initialise this process as rank 0 of a fake `torch.distributed`
    world the size of the production mesh (256, or 512 with `multi_pod`):
    a process group that carries the mesh's groups and takes collectives
    on meta tensors without moving data. Returns the world size; raises
    if another world is already up."""
    import torch.distributed as dist
    from torch.testing._internal.distributed.fake_pg import FakeStore

    size = 512 if multi_pod else 256
    if dist.is_initialized():
        if dist.get_backend() == "fake" and dist.get_world_size() == size:
            return size
        raise RuntimeError(f"a {dist.get_backend()} world of "
                           f"{dist.get_world_size()} ranks is already "
                           f"initialised; the dry run needs its own fake "
                           f"world of {size}")
    dist.init_process_group("fake", rank=0, world_size=size,
                            store=FakeStore())
    return size


# ---------------------------------------------------------------------------
# cells
# ---------------------------------------------------------------------------

Placed = List[Tuple[torch.Tensor, tuple]]     # (tensor, spec) pairs


def _dp_size(mesh) -> int:
    n = 1
    for a in dp_axes(mesh):
        n *= mesh.shape[a]
    return n


def _params_placed(params, mesh) -> Placed:
    specs = param_shardings(params, mesh)
    return [(p, specs[n]) for n, p in params.named_parameters()]


def _dict_placed(tree: Dict[str, torch.Tensor], mesh) -> Placed:
    specs = param_shardings(tree, mesh)
    return [(t, specs[n]) for n, t in tree.items()]


def _caches_placed(caches, mesh, cfg: ModelConfig, batch: int) -> Placed:
    specs = cache_shardings(caches, mesh, cfg, batch)
    return [(t, specs[path]) for path, _, t in cache_leaves(caches)]


@dataclasses.dataclass
class Cell:
    """One cell's step, ready to call: `run()` returns the step's outputs
    as (tensor, spec) pairs; `args` are its arguments' pairs."""
    specs: Dict[str, Any]
    args: Placed
    run: Callable[[], Placed]


def build_cell(cfg: ModelConfig, shape_name: str, mesh) -> Cell:
    """The cell's step function on meta arguments, with the production
    specs of every argument and output (the reference's in_shardings and
    out_shardings)."""
    specs = input_specs(cfg, shape_name)
    kind = specs["kind"]
    bspec = batch_spec(mesh)

    if kind == "train":
        params = make_trainable(param_shapes(cfg))
        opt_state = adamw.init(params)
        step_raw = make_train_step(cfg, adamw.AdamWConfig(),
                                   microbatches=1,
                                   compress_grads=False)

        def opt_placed(o) -> Placed:
            # moments follow the param shardings; scalar step replicated
            return ([(o.step, ())] + _dict_placed(o.mu, mesh)
                    + _dict_placed(o.nu, mesh))

        args = (_params_placed(params, mesh) + opt_placed(opt_state)
                + [(t, bspec) for t in specs["inputs"].values()])

        def run_train() -> Placed:
            p, o, _, m = step_raw(params, opt_state, None, specs["inputs"])
            return (_params_placed(p, mesh) + opt_placed(o)
                    + [(m["loss"], ())])

        return Cell(specs, args, run_train)

    params = param_shapes(cfg)
    if kind == "prefill":
        extras = {key: specs[key] for key in ("prefix_embeds",
                                              "encoder_embeds")
                  if key in specs}
        args = (_params_placed(params, mesh) + [(specs["tokens"], bspec)]
                + [(t, bspec) for t in extras.values()])
        vocab_ax = "model" if cfg.vocab % mesh.shape["model"] == 0 else None

        def run_prefill() -> Placed:
            # serving semantics: ONLY the last position's logits, as the
            # reference's prefill_fn (not the (B, S, V) fp32 tensor)
            with torch.no_grad():
                hidden = forward(params, specs["tokens"], cfg, remat=False,
                                 return_hidden=True, **extras)
                logits = (hidden[:, -1] @ lm_head_weight(params, cfg)
                          ).float()
            return [(logits, (dp_axes(mesh), vocab_ax))]

        return Cell(specs, args, run_prefill)

    # decode: ONE new token against caches of seq_len; the write position
    # is the host-side int seq - 1 (decode_step reads it as an int)
    caches = specs["caches"]
    batch_ok = specs["batch"] % _dp_size(mesh) == 0
    tok_spec = bspec if batch_ok else (None, None)
    enc = specs.get("encoder_out")
    args = (_params_placed(params, mesh)
            + _caches_placed(caches, mesh, cfg, specs["batch"])
            + [(specs["tokens"], tok_spec)]
            + ([(enc, tok_spec if batch_ok else (None, None, None))]
               if enc is not None else []))

    def run_decode() -> Placed:
        with torch.no_grad():
            logits, new_caches = decode_step(params, caches, specs["tokens"],
                                             specs["seq"] - 1, cfg,
                                             encoder_out=enc)
        return ([(logits, ())]
                + _caches_placed(new_caches, mesh, cfg, specs["batch"]))

    return Cell(specs, args, run_decode)


def _nbytes(x) -> int:
    """Bytes of the tensors in an op's argument or result (a tensor, or a
    list or tuple of them, as aten passes them)."""
    if isinstance(x, torch.Tensor):
        return x.numel() * x.element_size()
    if isinstance(x, (list, tuple)):
        return sum(_nbytes(y) for y in x)
    return 0


class ByteCounter(TorchDispatchMode):
    """Sums the bytes of every aten op's tensor inputs and outputs (views
    excluded: they move nothing). Unfused, so it lies above XLA's
    `bytes accessed`, which counts a fusion's operands once."""

    def __init__(self):
        super().__init__()
        self.bytes = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        if not func.is_view:
            self.bytes += (_nbytes(args) + _nbytes(tuple(kwargs.values()))
                           + _nbytes(out))
        return out


def trace_cell(cfg: ModelConfig, shape_name: str, mesh) -> Dict[str, Any]:
    """Build and call the cell's step once under the FLOP, byte and
    collective counters: {specs, args, outs, flops, bytes, collectives,
    build_s, trace_s}."""
    from torch.utils.flop_counter import FlopCounterMode

    t0 = time.time()
    cell = build_cell(cfg, shape_name, mesh)
    t_build = time.time() - t0
    bc = ByteCounter()
    with record_collectives() as cs, \
            FlopCounterMode(display=False) as fc, bc:
        outs = cell.run()
    return {"specs": cell.specs, "args": cell.args, "outs": outs,
            "flops": float(fc.get_total_flops()), "bytes": float(bc.bytes),
            "collectives": cs, "build_s": t_build,
            "trace_s": time.time() - t0 - t_build}


def placed_bytes(pairs: Placed, mesh) -> int:
    """Per-device bytes of (tensor, spec) pairs."""
    return sum(local_bytes(t, spec, mesh) for t, spec in pairs)


# ---------------------------------------------------------------------------
# calibration (measured on R*C worker processes)
# ---------------------------------------------------------------------------

def _calibrate_worker(rank: int, world: int, store_path: str, device: str,
                      plan_cache: str, plan_grid, reps: int, gemms) -> None:
    """One rank of the measurement mesh: NCCL on card `rank`, or gloo on
    the CPU. Rank 0 persists the fitted profile and its samples."""
    import torch.distributed as dist

    from repro_torch.hw.config import tpu_pod_as_accelerator
    from repro_torch.sim import calibrate as cal

    if device == "cuda":
        torch.cuda.set_device(rank)
        backend = "nccl"
    else:
        torch.set_num_threads(1)
        backend = "gloo"
    dist.init_process_group(backend, init_method=f"file://{store_path}",
                            rank=rank, world_size=world)
    try:
        hw = tpu_pod_as_accelerator(tuple(plan_grid))
        kw = {"gemms": tuple(map(tuple, gemms))} if gemms else {}
        profile, samples = cal.calibrate_mesh(hw, None, reps=reps, **kw)
        if rank == 0:
            cal.save_profile(plan_cache, profile)
            cal.save_samples(plan_cache, profile.hw_digest, samples)
        dist.barrier()
    finally:
        dist.destroy_process_group()


def calibrate_plan_cache(plan_cache: str, plan_grid, reps: int = 1,
                         device: str = "cuda", gemms=None
                         ) -> Dict[str, Any]:
    """Fit the SoftHier cost model to this host's measured mode efficiency.

    Runs `sim.calibrate.measure_modes` on a `plan_grid` mesh of R*C worker
    processes (every executable mode over the GEMM grid, lowering asserted
    clean): NCCL ranks, one a card, with `device="cuda"`, which needs R*C
    visible cards; gloo CPU processes with `device="cpu"`. The fake world
    of the dry run computes nothing, so it cannot be measured on. The
    fitted `CalibrationProfile` persists NEXT TO THE PLANS keyed by the
    pod-view hardware fingerprint — the same profile
    `deploy.warmup.build_planner` auto-loads. Returns the JSON
    `calibration` section (fit stats + measurement count).
    """
    import torch.multiprocessing as mp

    from repro_torch.hw.config import tpu_pod_as_accelerator
    from repro_torch.sim import calibrate as cal

    rows, cols = plan_grid
    if rows != cols or rows < 4:
        # the mode-case table needs a square grid for the cannon ring and
        # >= 4x4 for a non-degenerate outer ring of 2x2 inner groups —
        # fail with the requirement, not a deep clean-lowering assertion
        raise ValueError(
            f"--calibrate requires a square --plan-grid of at least 4x4 "
            f"(every executable mode must lower cleanly on the "
            f"measurement mesh); got {rows}x{cols}")
    world = rows * cols
    if device == "cuda":
        have = torch.cuda.device_count() if torch.cuda.is_available() else 0
        if have < world:
            raise RuntimeError(
                f"--calibrate on a {rows}x{cols} --plan-grid needs {world} "
                f"visible CUDA cards (one NCCL rank a card); {have} visible. "
                f"--calibrate-device cpu measures over {world} gloo CPU "
                f"processes instead")
    elif device != "cpu":
        raise ValueError(f"calibration device must be cuda or cpu, got "
                         f"{device!r}")
    hw = tpu_pod_as_accelerator(tuple(plan_grid))
    # the profile persisted by the PREVIOUS calibration run (if any): the
    # fresh measurements below, compared against ITS predictions, quantify
    # how far the machine drifted since it was fitted
    prior = cal.load_profile(plan_cache, hw)
    t0 = time.time()
    with tempfile.TemporaryDirectory() as tmp:
        mp.start_processes(_calibrate_worker,
                           args=(world, os.path.join(tmp, "store"), device,
                                 plan_cache, tuple(plan_grid), reps, gemms),
                           nprocs=world, join=True, start_method="spawn")
    profile = cal.load_profile(plan_cache, hw)
    samples = cal.load_samples(plan_cache, hw)
    path = cal._profile_path(plan_cache, profile.hw_digest)
    print(f"calibration: {profile.describe()} from {len(samples)} "
          f"measurements in {time.time()-t0:.1f}s -> {path}", flush=True)
    out = {
        "profile": profile.to_dict(),
        "profile_digest": profile.digest(),
        "samples": len(samples),
        "fit_ok": profile.fit_ok,
        "rank_agreement_before": profile.rank_agreement_before,
        "rank_agreement_after": profile.rank_agreement_after,
        "picks_measured_ratio": profile.picks_measured_ratio,
        "device": device,
    }
    if prior is not None:
        from repro_torch.obs import DriftMonitor
        mon = DriftMonitor(prior)
        mon.add_samples(samples)
        out["drift_vs_prior"] = mon.summary()
    return out


def calibration_rank_flips(planner, workload) -> Dict[str, Any]:
    """Re-tune the workload with and without the planner's profile and
    count schedules the calibrated ranking changed (fresh searches on both
    sides — the cache is not consulted, and BOTH searches enumerate the
    same dataflow space, so the report isolates the ranking effect of the
    measured scale factors from the trusted profile's search-space
    widening)."""
    from repro_torch.core.autotuner import default_dataflows, tune
    from repro_torch.sim.calibrate import is_trusted

    flips, flipped = 0, []
    shapes = list(dict.fromkeys(workload))
    out = {"workload_shapes": len(shapes), "trusted": True}
    if not is_trusted(planner.calibration):
        # an untrusted profile is defined to change no ranking (the tuner
        # ignores it), so the two searches below would be identical
        return {**out, "trusted": False, "rank_flips": 0, "flipped": []}
    space = planner.dataflows or default_dataflows(planner.calibration)
    for shape in shapes:
        kw = dict(dataflows=space,
                  elem_bytes=planner.elem_bytes,
                  max_candidates=planner.max_candidates,
                  store_stage_options=planner.store_stage_options)
        try:
            base = tune(shape, planner.hw, **kw)
            calib = tune(shape, planner.hw, calibration=planner.calibration,
                         **kw)
        except RuntimeError:
            continue
        if base.schedule != calib.schedule:
            flips += 1
            flipped.append({"shape": [shape.m, shape.n, shape.k],
                            "analytical": base.schedule.describe(),
                            "calibrated": calib.schedule.describe()})
    return {**out, "rank_flips": flips, "flipped": flipped}


# ---------------------------------------------------------------------------
# per-cell run
# ---------------------------------------------------------------------------

def install_plan_context(cfg: ModelConfig, shape_name: str, mesh,
                         plan_cache: str, plan_grid, route: bool,
                         route_dataflows=None,
                         calibration_out: Optional[Dict[str, Any]] = None
                         ) -> shard_ctx.GemmContext:
    """Install the cell's gemm context. Default: record-only — every pmm
    the cell traces is logged so the JSON can cross-validate
    model_workload (and the warmed plan cache) against the GEMMs this
    (arch x shape x mesh) really runs. `route` flips it live: the cell's
    workload is warmed into the planner and every model matmul runs
    through its tuned dataflow's mode body on `mesh`, with per-reason
    fallback counts in the JSON — no silent auto degrades."""
    from repro_torch.deploy.warmup import build_planner, warm_buckets
    planner = build_planner(plan_cache, plan_grid, max_candidates=12,
                            dataflows=route_dataflows)
    if route or calibration_out is not None:
        from repro_torch.deploy import model_workload
        specs0 = input_specs(cfg, shape_name)
        workload = model_workload(cfg, specs0["batch"], specs0["seq"],
                                  kind=specs0["kind"], dp=_dp_size(mesh))
    if calibration_out is not None:
        # how many of this cell's tuning decisions the measured scale
        # factors actually changed (fresh searches both sides)
        calibration_out.update(calibration_rank_flips(planner, workload))
    if route:
        warm_buckets(planner, workload)
        planner.batch_tune(workload, allow_bucketed=True,
                           skip_illegal=route_dataflows is not None)
        ctx = shard_ctx.GemmContext(mesh=mesh, planner=planner)
    else:
        ctx = shard_ctx.GemmContext(mesh=None, planner=planner)
    shard_ctx.set_gemm_context(ctx)
    return ctx


def workload_section(ctx: shard_ctx.GemmContext, cfg: ModelConfig,
                     specs: Dict[str, Any], mesh) -> Dict[str, Any]:
    """model_workload (dp from this mesh) against the shapes the trace
    observed, and how many of them the plan cache resolves."""
    from repro_torch.deploy import model_workload, workload_coverage
    observed = ctx.stats.observed_shapes()
    # dp matters: moe dispatch groups align to the mesh's DP axes, so
    # the predicted expert capacity must use this cell's mesh geometry
    predicted = model_workload(cfg, specs["batch"], specs["seq"],
                               kind=specs["kind"], dp=_dp_size(mesh))
    cov = workload_coverage(predicted, observed)
    resolved = sum(1 for s in observed
                   if ctx.planner.plan_cached(s) is not None)
    return {
        "observed": len(observed),
        "predicted": len(predicted),
        "covered": cov["covered"],
        "extra": [[s.m, s.n, s.k] for s in cov["extra"]],
        "missing": [[s.m, s.n, s.k] for s in cov["missing"]],
        "plan_resolved": resolved,
        "plan_resolve_rate": resolved / len(observed) if observed else 0.0,
    }


def routing_section(ctx: shard_ctx.GemmContext) -> Dict[str, Any]:
    st = ctx.stats
    return {
        "modes": dict(sorted(st.modes.items())),
        "degrade_reasons": dict(sorted(st.degrades.items())),
        # degraded == landed on auto; reasons like non_square_systolic
        # or a scatter demotion still execute a tuned dataflow
        "degraded": st.modes.get("auto", 0),
        "silent_auto_degrades": st.silent_degrades,
        "hits": st.hits, "bucketed": st.bucketed,
        "fallback": st.fallback,
        "resolve_rate": st.resolve_rate,
    }


NO_COLLECTIVES = "none (record-only: the unpartitioned step calls none)"
TEMP_NOTE = ("not measured: the eager step is not partitioned, so there is "
             "no per-device temp-buffer count")
PEAK_NOTE = ("arguments + outputs only (temp buffers not measured)")


def roofline(flops: float, nbytes: float, coll: Optional[float],
             n_chips: int) -> Dict[str, Any]:
    """The three roofline terms in seconds per chip, from the H100's
    data-sheet constants (computed, not measured), for a global count
    spread over the chips. The collective term prices every byte at the
    card's 50 GB/s NIC: each 16-wide mesh axis spans two 8-card NVLink
    nodes, so every collective of the production mesh crosses the
    inter-node network."""
    chip = H100_SXM
    out: Dict[str, Any] = {
        "compute_s": flops / (n_chips * chip.peak_flops_bf16),
        "memory_s": nbytes / (n_chips * chip.hbm_bw),
        "collective_s": (None if coll is None
                         else coll / (n_chips * chip.nic_bw)),
    }
    terms = {k: v for k, v in out.items() if v is not None}
    out["dominant"] = max(terms, key=terms.get)
    tot = max(terms.values())
    out["roofline_fraction"] = out["compute_s"] / tot if tot else 0.0
    out["constants"] = chip.name + " data sheet"
    return out


def run_cell(arch: str, shape_name: str, multi_pod: bool,
             skip_accounting: bool = False,
             plan_cache: str = "",
             plan_grid=(4, 4),
             route: bool = False,
             route_dataflows=None,
             calibrate: bool = False,
             calibrate_device: str = "cuda") -> Dict[str, Any]:
    cfg = get_config(arch)
    init_fake_world(multi_pod)
    mesh = make_production_mesh(multi_pod=multi_pod)
    n_chips = mesh.size
    shard_ctx.set_mesh(mesh)   # moe dispatch groups follow the DP axes
    gemm_ctx = None
    calibration_out = None
    scope = "rank 0" if route else "global"
    if plan_cache:
        # structured dispatch tracer: every pmm the cell traces emits a
        # provenance span; main() exports <tag>.trace.json + the run report
        from repro_torch.obs import Tracer, set_tracer
        set_tracer(Tracer(process_name=f"dryrun.{arch}.{shape_name}"))
    if calibrate:
        # fit + persist BEFORE the planner is built so the warm-up below
        # already tunes with the measured cost model
        calibration_out = calibrate_plan_cache(plan_cache, plan_grid,
                                               device=calibrate_device)
    if plan_cache:
        gemm_ctx = install_plan_context(cfg, shape_name, mesh, plan_cache,
                                        plan_grid, route, route_dataflows,
                                        calibration_out)
    out: Dict[str, Any] = {
        "arch": arch, "shape": shape_name, "multi_pod": multi_pod,
        "mesh": dict(mesh.shape),
        "routed": bool(route),
        "scope": scope,
    }
    if calibration_out is not None:
        out["calibration"] = calibration_out
    t0 = time.time()

    # 1. FULL config: one traced call + per-device memory from the specs
    tr = trace_cell(cfg, shape_name, mesh)
    specs = tr["specs"]
    arg_b = placed_bytes(tr["args"], mesh)
    out_b = placed_bytes(tr["outs"], mesh)
    cs = tr["collectives"]
    out["full"] = {
        "lower_s": round(tr["build_s"], 1), "compile_s": round(tr["trace_s"], 1),
        "argument_bytes_per_device": arg_b,
        "output_bytes_per_device": out_b,
        "temp_bytes_per_device": None,
        "temp_bytes_note": TEMP_NOTE,
        "peak_bytes_per_device": arg_b + out_b,
        "peak_bytes_note": PEAK_NOTE,
        "hlo_flops_raw": tr["flops"],
        "hlo_bytes_raw": tr["bytes"],
        "collective_bytes_raw": float(cs.total_bytes) if route else None,
        "collectives": cs.summary() if route else NO_COLLECTIVES,
    }
    del tr

    if gemm_ctx is not None:
        out["workload"] = workload_section(gemm_ctx, cfg, specs, mesh)
        if route:
            out["routing"] = routing_section(gemm_ctx)

    if plan_cache:
        # predicted-vs-measured drift of the persisted calibration profile
        # against the persisted measurement samples (written next to it by
        # --calibrate; present on this run when --calibrate just ran, or
        # from an earlier calibration of the same cache dir)
        from repro_torch.hw.config import tpu_pod_as_accelerator
        from repro_torch.obs import DriftMonitor
        from repro_torch.sim import calibrate as cal
        hw_pod = tpu_pod_as_accelerator(tuple(plan_grid))
        profile = cal.load_profile(plan_cache, hw_pod)
        samples = cal.load_samples(plan_cache, hw_pod)
        if profile is not None and samples:
            mon = DriftMonitor(profile)
            mon.add_samples(samples)
            out["drift"] = mon.summary()

    # 2. accounting configs for the roofline terms
    if not skip_accounting:
        c1, c2, units_full, u1, u2 = accounting_configs(cfg)
        vals = {}
        for tag, c in (("small", c1), ("big", c2)):
            with accounting.accounting_mode(specs["seq"]):
                t = trace_cell(c, shape_name, mesh)
            vals[tag] = {"flops": t["flops"], "bytes": t["bytes"],
                         "coll": (float(t["collectives"].total_bytes)
                                  if route else None)}
            del t
        scale = (units_full - u1) / (u2 - u1)
        extr = {k: (None if vals["small"][k] is None else
                    vals["small"][k]
                    + scale * (vals["big"][k] - vals["small"][k]))
                for k in ("flops", "bytes", "coll")}
        mf = flops_lib.model_flops(cfg, specs["batch"], specs["seq"],
                                   specs["kind"])
        acc = {
            "per_unit": vals, "units_full": units_full,
            "scope": scope,
            "hlo_flops": extr["flops"], "hlo_bytes": extr["bytes"],
            "collective_bytes": extr["coll"],
            "model_flops": mf["total"],
            "model_flops_breakdown": mf,
        }
        if scope == "global":
            acc["useful_ratio"] = (mf["total"] / extr["flops"]
                                   if extr["flops"] else 0.0)
        else:
            acc["useful_ratio"] = None
            acc["useful_ratio_note"] = (
                "rank 0's trace holds its share of the routed matmuls and "
                "the whole of everything else: no global count to hold "
                "model_flops against")
        out["accounting"] = acc
        if scope == "global":
            out["roofline"] = roofline(extr["flops"], extr["bytes"],
                                       extr["coll"], n_chips)
        else:
            out["roofline"] = None
            out["roofline_note"] = (
                "rank 0's counts mix its share of the routed matmuls with "
                "the whole of everything else: they describe no one chip")

    out["elapsed_s"] = round(time.time() - t0, 1)
    return out


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--shape", required=True, choices=list(SHAPES))
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--skip-accounting", action="store_true")
    ap.add_argument("--plan-cache", default="",
                    help="warmed plan-cache dir; enables the record-only "
                         "gemm context + workload coverage report")
    ap.add_argument("--plan-grid", type=int, nargs=2, default=(4, 4),
                    metavar=("R", "C"),
                    help="pod grid the cache was warmed for (fingerprint)")
    ap.add_argument("--route", action="store_true",
                    help="trace with plan routing ON: warm the planner for "
                         "this cell's workload and dispatch every model "
                         "matmul through its tuned dataflow's collectives "
                         "on the production mesh (requires --plan-cache); "
                         "the JSON gains a 'routing' section with "
                         "per-reason fallback counts")
    ap.add_argument("--route-dataflows", nargs="+", default=None,
                    metavar="DF",
                    help="restrict the warm-up's candidate search to these "
                         "schedule dataflows (e.g. systolic_over_summa to "
                         "prove the Fig. 6c outer-systolic mode on the "
                         "production mesh); shapes with no legal restricted "
                         "schedule stay unplanned and dispatch as auto "
                         "fallbacks")
    ap.add_argument("--calibrate", action="store_true",
                    help="fit the SoftHier cost model to measured mode "
                         "efficiency before warming: run every executable "
                         "mode on a --plan-grid mesh of R*C worker "
                         "processes, least-squares-fit per-resource scale "
                         "factors, persist the profile into --plan-cache "
                         "(keyed by hw fingerprint, auto-loaded by later "
                         "warm-ups), re-tune this cell's workload and "
                         "report rank-flip counts in the JSON "
                         "'calibration' section")
    ap.add_argument("--calibrate-device", choices=("cuda", "cpu"),
                    default="cuda",
                    help="where --calibrate's R*C workers run: cuda (NCCL, "
                         "one rank a card; raises unless R*C cards are "
                         "visible) or cpu (gloo processes). The dry run's "
                         "own fake world moves no data, so the measurement "
                         "needs real ranks, and a missing card never "
                         "switches it to the CPU")
    ap.add_argument("--out", default="results/dryrun")
    args = ap.parse_args(argv)
    if args.route and not args.plan_cache:
        ap.error("--route requires --plan-cache")
    if args.route_dataflows and not args.route:
        ap.error("--route-dataflows requires --route")
    if args.calibrate and not args.plan_cache:
        ap.error("--calibrate requires --plan-cache (the profile persists "
                 "next to the plans it calibrates)")

    os.makedirs(args.out, exist_ok=True)
    tag = f"{args.arch}__{args.shape}__{'mp' if args.multi_pod else 'sp'}"
    if args.route:
        tag += "__routed"
    path = os.path.join(args.out, tag + ".json")
    try:
        result = run_cell(args.arch, args.shape, args.multi_pod,
                          skip_accounting=args.skip_accounting,
                          plan_cache=args.plan_cache,
                          plan_grid=args.plan_grid,
                          route=args.route,
                          route_dataflows=args.route_dataflows,
                          calibrate=args.calibrate,
                          calibrate_device=args.calibrate_device)
        result["status"] = "ok"
    except Exception as e:
        result = {"arch": args.arch, "shape": args.shape,
                  "multi_pod": args.multi_pod, "status": "error",
                  "error": f"{type(e).__name__}: {e}",
                  "traceback": traceback.format_exc()[-3000:]}
    with open(path, "w") as f:
        json.dump(result, f, indent=1)

    # observability artifacts alongside the cell JSON: the versioned run
    # report + the Perfetto-loadable dispatch trace. launch/report.py
    # skips both suffixes when globbing cells.
    from repro_torch.obs import build_run_report, get_tracer, write_run_report
    ctx = shard_ctx.get_gemm_context()
    tracer = get_tracer()
    if ctx is not None or tracer is not None:
        run_report = build_run_report(
            "dryrun",
            stats=ctx.stats.to_dict() if ctx is not None else None,
            workload=result.get("workload"),
            drift=result.get("drift"),
            calibration=result.get("calibration"),
            tracer=tracer,
            extra={"arch": args.arch, "shape": args.shape,
                   "multi_pod": args.multi_pod, "routed": args.route,
                   "status": result["status"]})
        rr_path = write_run_report(
            os.path.join(args.out, tag + ".run_report.json"), run_report)
        print(f"run report -> {rr_path}")
        if tracer is not None:
            print(f"trace -> "
                  f"{tracer.write(os.path.join(args.out, tag + '.trace.json'))}")

    print(json.dumps({k: v for k, v in result.items() if k != "traceback"},
                     indent=1))
    if result["status"] != "ok":
        raise SystemExit(1)


if __name__ == "__main__":
    main()
