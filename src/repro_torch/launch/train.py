"""Training launcher.

Port of `repro/launch/train.py`:

  PYTHONPATH=src python -m repro_torch.launch.train --arch gemma-2b \\
      --smoke --device cpu --steps 4 --batch 2 --seq 32

Runs on the card unless `--device cpu` is given; with no card it raises.
`--smoke` trains the reduced config on the host's mesh with whole
parameters, as the reference does. Without it the model is the full
configuration on the production mesh (`make_production_mesh`, 16x16, or
2x16x16 with `--multi-pod`), which needs a `torch.distributed` world of
exactly 256 (or 512) ranks, one per card: the parameters, the AdamW
moments and the compression residual are kept sharded by `spec_rules`
(`parallel.sharded`), the batch splits over the `pod` axis and the matmuls
route over the mesh, as the reference's. `setup(args, cfg, mesh)` trains
on any `DistMesh` a caller made (`make_dist_mesh`; the tests run 4 gloo
ranks on the CPU, `chip_smoke.py` a world of one rank on the card).

Features: deterministic stateless data, microbatching, optional int8
gradient compression, atomic checkpoints + auto-resume, heartbeat files,
straggler logging. At startup the deployment-plan cache is warmed for the
training workload and installed as the model stack's gemm context, so the
forward (and recomputed) matmuls route through `dit_gemm(exec_plan=...)`
and the `mmad` kernel, and their backward runs `local_matmul`'s two
products (on `mmad` for bf16 operands on the card; an MoE model's fp32
router takes fp32 `torch.matmul`). `--skip-plan-warmup` turns both off.
The run report is built at the end; on several ranks only rank 0 prints
and writes it.

`setup` builds everything but the loop (config, mesh, planner, routing
context, step function, state factory), so a caller can drive the same
step without the loop's checkpoints (`chip_smoke.py` does, at full
width); `run` is the loop; `main` parses the flags and calls both.
"""
from __future__ import annotations

import argparse
import dataclasses
import math
import time
from typing import Any, Callable, Dict, Optional

import numpy as np
import torch

from repro_torch.configs import get_config, smoke_config
from repro_torch.data.pipeline import DataConfig, SyntheticLM
from repro_torch.deploy.warmup import add_plan_args
from repro_torch.ft.runtime import FailureInjector, LoopConfig, run_training
from repro_torch.launch.mesh import (HostMesh, make_host_mesh,
                                     make_production_mesh, resolve_device)
from repro_torch.models import shard_ctx
from repro_torch.models.common import ModelConfig
from repro_torch.models.model import init_params, make_trainable
from repro_torch.obs import (Tracer, build_run_report, render_run_report,
                             set_tracer, write_run_report)
from repro_torch.optim import adamw, compress
from repro_torch.parallel import sharded, spec_rules
from repro_torch.train.steps import make_train_step


def parse_args(argv=None) -> argparse.Namespace:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--smoke", action="store_true",
                    help="reduced config (CPU-runnable with --device cpu)")
    ap.add_argument("--device", default="cuda",
                    help="torch device to train on (default: the card; "
                         "'cpu' runs the kernels' plain versions)")
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--microbatches", type=int, default=1)
    ap.add_argument("--compress-grads", action="store_true")
    ap.add_argument("--ckpt-dir", default="results/train_ckpt")
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--run-report", default="results/train_run_report.json",
                    help="where to write the versioned run report "
                         "('' disables)")
    ap.add_argument("--trace", default="",
                    help="write a Perfetto-loadable Chrome trace here")
    add_plan_args(ap)
    return ap.parse_args(argv)


@dataclasses.dataclass
class TrainSetup:
    """What `setup` builds: everything a training run needs but the loop."""
    args: argparse.Namespace
    cfg: ModelConfig
    device: torch.device
    opt: adamw.AdamWConfig
    data: SyntheticLM
    train_step: Callable            # (params, opt, comp, batch) -> (..., metrics)
    planner: Optional[Any] = None
    gemm_ctx: Optional[shard_ctx.GemmContext] = None
    tracer: Optional[Tracer] = None
    mesh: Optional[Any] = None      # a DistMesh: the state is sharded on it

    @property
    def rank(self) -> int:
        return 0 if self.mesh is None else self.mesh.rank

    def init_state(self):
        """A fresh (params, AdamW state, compress state or None), params
        drawn from seed 0 (the reference's `PRNGKey(0)`) on the device and
        made trainable; on a mesh, each rank keeps its blocks (every rank
        draws the same whole parameters first), and the moments and the
        residual are made at the blocks' shapes. On the meta device the
        parameters are an uninitialised shell."""
        gen = (None if self.device.type == "meta" else
               torch.Generator(device=self.device).manual_seed(0))
        params = make_trainable(init_params(gen, self.cfg, self.device))
        if self.mesh is not None:
            sharded.shard_params(params, self.mesh)
        comp = (compress.init(params) if self.args.compress_grads else None)
        return params, adamw.init(params), comp

    def step_fn(self, state, batch):
        p, o, c = state
        p, o, c, m = self.train_step(p, o, c, batch)
        return (p, o, c), m

    def batch_arrays(self, batch: Dict[str, np.ndarray]
                     ) -> Dict[str, torch.Tensor]:
        return {k: torch.from_numpy(v).to(self.device, torch.long)
                for k, v in batch.items()}


def warm_train_plans(cfg: ModelConfig, batch: int, seq: int, cache_dir: str,
                     grid, max_candidates: int, online_tune: bool = True,
                     dp: int = 1, pods: int = 1, mesh=None):
    """Tune the training workload's pow-2 buckets into the plan cache,
    priced on the view of `mesh`'s device (`deploy.warmup.plan_view`:
    the card view on a CUDA mesh, the TPU pod view at `grid` otherwise),
    then
    serve its exact shapes from them (warm hits or cheap bucketed
    transfers, never a second full search). `dp` is the reference's (the
    mesh's `pod` x `data`); with the batch split over `pods` pods each
    runs its share, `batch // pods` rows in `1 / pods` of the MoE
    dispatch groups, and those are the shapes warmed."""
    from repro_torch.deploy import model_workload
    from repro_torch.deploy.warmup import build_planner, warm_buckets
    if batch % pods:
        raise ValueError(f"batch {batch} does not split over {pods} pods")
    planner = build_planner(cache_dir, grid, max_candidates,
                            online_tune=online_tune, mesh=mesh)
    workload = model_workload(cfg, batch // pods, seq, kind="train",
                              dp=dp // pods)
    warm_buckets(planner, workload)
    planner.batch_tune(workload, allow_bucketed=True)
    return planner


def setup(args: argparse.Namespace, cfg: Optional[ModelConfig] = None,
          mesh=None) -> TrainSetup:
    """Resolve the device, the config and the mesh, warm the plan cache and
    install the routing context and tracer (unless `--skip-plan-warmup`),
    and build the step function. `cfg`, when given, is the model to train
    in place of the one `--arch` / `--smoke` name (a caller's depth cut of
    it, say). `mesh`, when given, is the mesh to train on in place of the
    one the flags name (the production mesh without `--smoke`, whose world
    must hold exactly its ranks; the host's 1x1 mesh with it): a
    `DistMesh` keeps the state sharded on it, the host's `HostMesh`
    (`make_host_mesh`) keeps it whole on one device, as `--smoke` does
    (a full-width model on one card: `chip_smoke.py`, `tools/`)."""
    device = resolve_device(args.device)
    if mesh is None and not args.smoke:
        mesh = make_production_mesh(multi_pod=args.multi_pod, device=device)
    if mesh is not None and torch.device(mesh.device) != device:
        raise ValueError(f"the mesh is on {mesh.device}, the flags ask for "
                         f"{device}")
    host_mesh = mesh if isinstance(mesh, HostMesh) else None
    if host_mesh is not None:
        mesh = None                     # whole parameters on the host
    if cfg is None:
        cfg = smoke_config(args.arch) if args.smoke else get_config(args.arch)
    pods = 1 if mesh is None else int(mesh.shape.get("pod", 1))
    # the data-parallel size the reference passes to `model_workload`
    dp = 1 if mesh is None else math.prod(int(mesh.shape[a])
                                          for a in spec_rules.dp_axes(mesh))
    if args.batch % (pods * args.microbatches):
        raise ValueError(f"batch {args.batch} does not split into "
                         f"{args.microbatches} microbatches over {pods} "
                         f"pods")
    shard_ctx.set_mesh(mesh, pod_batch=True)
    planner = gemm_ctx = tracer = None
    if not args.skip_plan_warmup:
        route_mesh = mesh or host_mesh or make_host_mesh(device)
        planner = warm_train_plans(cfg, args.batch, args.seq,
                                   args.plan_cache, args.plan_grid,
                                   args.plan_candidates,
                                   online_tune=not args.no_online_tune,
                                   dp=dp, pods=pods, mesh=route_mesh)
        gemm_ctx = shard_ctx.GemmContext(mesh=route_mesh, planner=planner)
        shard_ctx.set_gemm_context(gemm_ctx)
        tracer = Tracer(process_name=f"train.{cfg.name}")
        set_tracer(tracer)
    opt = adamw.AdamWConfig(lr=args.lr, warmup_steps=max(5, args.steps // 20),
                            total_steps=args.steps)
    train_step = make_train_step(cfg, opt, microbatches=args.microbatches,
                                 compress_grads=args.compress_grads)
    data = SyntheticLM(DataConfig(vocab=cfg.vocab, seq_len=args.seq,
                                  global_batch=args.batch))
    return TrainSetup(args=args, cfg=cfg, device=device, opt=opt, data=data,
                      train_step=train_step, planner=planner,
                      gemm_ctx=gemm_ctx, tracer=tracer, mesh=mesh)


def run(s: TrainSetup, injector: Optional[FailureInjector] = None,
        on_metrics: Optional[Callable[[int, Dict], None]] = None):
    """The crash-resumable loop over `s.args.steps` steps, checkpointing
    into `s.args.ckpt_dir`; returns the final state."""
    args = s.args
    return run_training(s.step_fn, s.init_state, s.data,
                        LoopConfig(total_steps=args.steps,
                                   ckpt_every=args.ckpt_every,
                                   ckpt_dir=args.ckpt_dir, host=s.rank),
                        make_batch_arrays=s.batch_arrays, injector=injector,
                        on_metrics=on_metrics)


def main(argv=None) -> Optional[dict]:
    """Train; returns the run report (None with `--skip-plan-warmup`)."""
    args = parse_args(argv)
    s = setup(args)
    t_last = [time.time()]
    last = {}

    def on_metrics(step, m):
        last.update(step=step, **{k: float(v) for k, v in m.items()})
        if step % args.log_every == 0 and s.rank == 0:
            dt = time.time() - t_last[0]
            t_last[0] = time.time()
            toks = args.batch * args.seq * args.log_every
            print(f"step {step:5d} loss {last['loss']:.4f} "
                  f"lr {last['lr']:.2e} gnorm {last.get('grad_norm', 0):.2f} "
                  f"tok/s {toks / max(dt, 1e-9):,.0f}", flush=True)

    run(s, on_metrics=on_metrics)
    report = None
    if s.gemm_ctx is not None and s.rank == 0:
        from repro_torch.launch.serve import load_drift
        drift = load_drift(args.plan_cache, args.plan_grid,
                           mesh=s.gemm_ctx.mesh)
        report = build_run_report(
            "train", stats=s.gemm_ctx.stats.to_dict(), drift=drift,
            tracer=s.tracer,
            extra={"arch": s.cfg.name, "steps": args.steps,
                   "batch": args.batch, "seq": args.seq,
                   "device": str(s.device), "final_loss": last.get("loss")})
        for line in render_run_report(report):
            print(line)
        if args.run_report:
            write_run_report(args.run_report, report)
            print(f"run report: {args.run_report}")
        if args.trace and s.tracer is not None:
            s.tracer.write(args.trace)
            print(f"chrome trace: {args.trace}")
    if s.rank == 0:
        print("done.")
    return report


if __name__ == "__main__":
    main()
