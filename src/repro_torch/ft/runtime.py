"""Fault-tolerance runtime: crash-resume training loop, heartbeats,
straggler logging.

Port of `repro/ft/runtime.py`, with the same restart semantics:
- every step's data is a pure function of the step index
  (`repro_torch.data`), so resume and straggler paths never replay or
  desynchronize;
- checkpoints are atomic (`repro_torch.ckpt`), saved every `ckpt_every`
  steps and at the last step; on a failure the loop restores the latest
  one and continues, or starts over from a fresh state when there is none;
- a `FailureInjector` hook lets tests fail chosen steps to prove the
  recovery path;
- heartbeats are per-host liveness files: a coordinator (or test) detects
  a silent host by mtime staleness.

The step updates its state in place (`optim.adamw.apply`), so the loop
cannot keep the first state aside to start over from, as the reference
does: it takes `init_state` as a function that builds a fresh state, and
calls it at the start and on a restart that finds no checkpoint.
Re-meshing onto a resized cluster (`elastic_reshard`) waits for
multi-rank training with sharded parameters. The reference's `LoopConfig.drop_straggler_batches` is
left out: its loop never reads it, so a straggling step is only logged.
"""
from __future__ import annotations

import dataclasses
import os
import time
from typing import Any, Callable, Dict, Optional

import numpy as np

from repro_torch.ckpt.manager import CheckpointManager
from repro_torch.data.pipeline import SyntheticLM


class Heartbeat:
    def __init__(self, directory: str, host: int):
        self.path = os.path.join(directory, f"host_{host}.hb")
        os.makedirs(directory, exist_ok=True)

    def beat(self) -> None:
        with open(self.path, "w") as f:
            f.write(str(time.time()))

    @staticmethod
    def stale_hosts(directory: str, timeout: float) -> list:
        now = time.time()
        stale = []
        for name in sorted(os.listdir(directory)):
            if name.endswith(".hb"):
                mtime = os.path.getmtime(os.path.join(directory, name))
                if now - mtime > timeout:
                    stale.append(int(name.split("_")[1].split(".")[0]))
        return stale


class FailureInjector:
    """Deterministically fail at given steps — once each (tests)."""

    def __init__(self, fail_at: Optional[set] = None):
        self.fail_at = set(fail_at or ())
        self.failed = set()

    def maybe_fail(self, step: int) -> None:
        if step in self.fail_at and step not in self.failed:
            self.failed.add(step)
            raise RuntimeError(f"injected failure at step {step}")


@dataclasses.dataclass
class LoopConfig:
    total_steps: int
    ckpt_every: int = 50
    ckpt_dir: str = "results/train_ckpt"
    max_restarts: int = 3
    heartbeat_dir: Optional[str] = None
    host: int = 0
    # straggler logging: a step that takes > straggler_factor x the median
    # of the last 20 is marked in its metrics
    straggler_factor: float = 3.0


def run_training(step_fn: Callable, init_state: Callable[[], Any],
                 data: SyntheticLM, loop: LoopConfig,
                 make_batch_arrays: Callable[[Dict[str, np.ndarray]], Any],
                 injector: Optional[FailureInjector] = None,
                 on_metrics: Optional[Callable[[int, Dict], None]] = None
                 ) -> Any:
    """Crash-resumable loop. `step_fn(state, batch) -> (state, metrics)`.
    `init_state()` builds a freshly initialised state; if a checkpoint
    exists the loop resumes from it."""
    mgr = CheckpointManager(loop.ckpt_dir)
    hb = Heartbeat(loop.heartbeat_dir, loop.host) if loop.heartbeat_dir else None

    restarts = 0
    state = init_state()
    start = 0
    latest = mgr.latest_step()
    if latest is not None:
        state = mgr.restore(latest, state)
        start = latest + 1

    durations = []
    step = start
    while step < loop.total_steps:
        try:
            if injector is not None:
                injector.maybe_fail(step)
            t0 = time.monotonic()
            batch = make_batch_arrays(data.batch(step))
            state, metrics = step_fn(state, batch)
            dt = time.monotonic() - t0
            durations.append(dt)
            med = float(np.median(durations[-20:]))
            if dt > loop.straggler_factor * med and len(durations) > 5:
                metrics = dict(metrics)
                metrics["straggler"] = dt / med
            if hb:
                hb.beat()
            if on_metrics:
                on_metrics(step, metrics)
            if (step + 1) % loop.ckpt_every == 0 or step + 1 == loop.total_steps:
                mgr.save(step, state, extra={"time": time.time()})
            step += 1
        except Exception:
            restarts += 1
            if restarts > loop.max_restarts:
                raise
            latest = mgr.latest_step()
            if latest is not None:
                state = mgr.restore(latest, state)
                step = latest + 1
            else:
                state = init_state()
                step = 0
    return state


def elastic_reshard(params: Any, new_mesh, shardings_fn) -> Any:
    """Re-place a parameter state onto a resized mesh (node loss or gain)."""
    raise NotImplementedError(
        "elastic_reshard needs parameters sharded over a multi-rank mesh "
        "(ROADMAP.md, queue 1: multi-rank training with sharded "
        "parameters)")
