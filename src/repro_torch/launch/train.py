"""Training launcher.

Port of `repro/launch/train.py` on one device (the device's 1x1 mesh):

  PYTHONPATH=src python -m repro_torch.launch.train --arch gemma-2b \\
      --smoke --device cpu --steps 4 --batch 2 --seq 32

Runs on the card unless `--device cpu` is given; with no card it raises.
Without `--smoke` the model is the full configuration, still on one device
(`--multi-pod` waits for multi-rank training with sharded parameters).

Features: deterministic stateless data, microbatching, optional int8
gradient compression, atomic checkpoints + auto-resume, heartbeat files,
straggler logging. At startup the deployment-plan cache is warmed for the
training workload and installed as the model stack's gemm context, so the
forward (and recomputed) matmuls route through `dit_gemm(exec_plan=...)`
and the `mmad` kernel, and their backward runs `local_matmul`'s two
products (on `mmad` for bf16 operands on the card; an MoE model's fp32
router takes fp32 `torch.matmul`). `--skip-plan-warmup` turns both off.
The run report is built at the end.

`setup` builds everything but the loop (config, planner, routing context,
step function, state factory), so a caller can drive the same step without
the loop's checkpoints (`chip_smoke.py` does, at full width); `run` is the
loop; `main` parses the flags and calls both.
"""
from __future__ import annotations

import argparse
import dataclasses
import time
from typing import Any, Callable, Dict, Optional

import numpy as np
import torch

from repro_torch.configs import get_config, smoke_config
from repro_torch.data.pipeline import DataConfig, SyntheticLM
from repro_torch.deploy.warmup import add_plan_args
from repro_torch.ft.runtime import FailureInjector, LoopConfig, run_training
from repro_torch.launch.mesh import make_host_mesh, resolve_device
from repro_torch.models import shard_ctx
from repro_torch.models.common import ModelConfig
from repro_torch.models.model import init_params, make_trainable
from repro_torch.obs import (Tracer, build_run_report, render_run_report,
                             set_tracer, write_run_report)
from repro_torch.optim import adamw, compress
from repro_torch.train.steps import make_train_step

_ROADMAP_MULTI_RANK = ("ROADMAP.md, queue 1: multi-rank training with "
                       "sharded parameters")


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

    def init_state(self):
        """A fresh (params, AdamW state, compress state or None), params
        drawn from seed 0 (the reference's `PRNGKey(0)`) on the device and
        made trainable."""
        gen = torch.Generator(device=self.device).manual_seed(0)
        params = make_trainable(init_params(gen, self.cfg, self.device))
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
                     grid, max_candidates: int, online_tune: bool = True):
    """Tune the training workload's pow-2 buckets into the plan cache, then
    serve its exact shapes from them (warm hits or cheap bucketed
    transfers, never a second full search)."""
    from repro_torch.deploy import model_workload
    from repro_torch.deploy.warmup import build_planner, warm_buckets
    planner = build_planner(cache_dir, grid, max_candidates,
                            online_tune=online_tune)
    workload = model_workload(cfg, batch, seq, kind="train")
    warm_buckets(planner, workload)
    planner.batch_tune(workload, allow_bucketed=True)
    return planner


def setup(args: argparse.Namespace,
          cfg: Optional[ModelConfig] = None) -> TrainSetup:
    """Resolve the device and config, warm the plan cache and install the
    routing context and tracer (unless `--skip-plan-warmup`), and build the
    step function. `cfg`, when given, is the model to train in place of the
    one `--arch` / `--smoke` name (a caller's depth cut of it, say)."""
    if args.multi_pod:
        raise NotImplementedError(
            f"--multi-pod needs a multi-rank mesh ({_ROADMAP_MULTI_RANK})")
    device = resolve_device(args.device)
    if cfg is None:
        cfg = smoke_config(args.arch) if args.smoke else get_config(args.arch)
    planner = gemm_ctx = tracer = None
    if not args.skip_plan_warmup:
        planner = warm_train_plans(cfg, args.batch, args.seq,
                                   args.plan_cache, args.plan_grid,
                                   args.plan_candidates,
                                   online_tune=not args.no_online_tune)
        gemm_ctx = shard_ctx.GemmContext(mesh=make_host_mesh(device),
                                         planner=planner)
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
                      gemm_ctx=gemm_ctx, tracer=tracer)


def run(s: TrainSetup, injector: Optional[FailureInjector] = None,
        on_metrics: Optional[Callable[[int, Dict], None]] = None):
    """The crash-resumable loop over `s.args.steps` steps, checkpointing
    into `s.args.ckpt_dir`; returns the final state."""
    args = s.args
    return run_training(s.step_fn, s.init_state, s.data,
                        LoopConfig(total_steps=args.steps,
                                   ckpt_every=args.ckpt_every,
                                   ckpt_dir=args.ckpt_dir),
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
        if step % args.log_every == 0:
            dt = time.time() - t_last[0]
            t_last[0] = time.time()
            toks = args.batch * args.seq * args.log_every
            print(f"step {step:5d} loss {last['loss']:.4f} "
                  f"lr {last['lr']:.2e} gnorm {last.get('grad_norm', 0):.2f} "
                  f"tok/s {toks / max(dt, 1e-9):,.0f}", flush=True)

    run(s, on_metrics=on_metrics)
    report = None
    if s.gemm_ctx is not None:
        from repro_torch.launch.serve import load_drift
        drift = load_drift(args.plan_cache, args.plan_grid)
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
    print("done.")
    return report


if __name__ == "__main__":
    main()
