"""Traffic generator: training steps through the port's launcher.

Set-up builds one training object with `launch.train.setup` (plans warmed
for the train workload into a fresh cache under the run's temporary
directory, the routing context installed, remat, chunked cross-entropy
and the port's AdamW) on the card's host mesh, loads the weights the
benchmark draws from the seed into the program's model, makes the AdamW
state, and drives `TrainSetup.step_fn` through the first steps, whose
readings the check holds to the reference. The configuration is run as
its file states it, departures from the published model included
(`moe_lm.as_run`). The window then continues the
same object: a fresh batch of uniform tokens each step, no host sync of
the loop's own, and one synchronize at the end.
"""
from __future__ import annotations

import gc
import math
import shutil
import sys
import tempfile
import time
from typing import Dict, List

import torch

from bench.harness.core import Check
from bench.harness.yardstick import train_flops
from bench.reference import moe_lm

CHECKED_STEPS = 3       # the first steps, held to the reference
TRACED_STEPS = 2        # steps in each profiled sub-window


# the configuration file's keys (the published `config.json`'s names) by the
# program's `ModelConfig` field each sets
PROGRAM_KEYS = {"n_layers": "num_hidden_layers", "d_model": "hidden_size",
                "n_heads": "num_attention_heads",
                "n_kv_heads": "num_key_value_heads", "head_dim": "head_dim",
                "d_ff": "intermediate_size", "vocab": "vocab_size",
                "n_experts": "n_routed_experts",
                "n_shared_experts": "n_shared_experts",
                "moe_top_k": "num_experts_per_tok",
                "moe_d_ff": "moe_intermediate_size",
                "n_dense_layers": "first_k_dense_replace",
                "tie_embeddings": "tie_word_embeddings",
                "rope_theta": "rope_theta",
                "capacity_factor": "capacity_factor"}


def program_config(c: Dict):
    """The configuration file as the program's `ModelConfig` (its other
    fields at their defaults: RMSNorm, SwiGLU, attention blocks, bf16)."""
    from repro_torch.models.common import ModelConfig
    return ModelConfig(name=c["name"], **{f: c[k] for f, k in
                                         PROGRAM_KEYS.items()})


class Traffic:
    kind = "train"

    def __init__(self, cell: Dict, config: Dict, seed: int, device):
        self.c, self.seed = moe_lm.as_run(config), seed
        self.t = cell["traffic"]
        self.keep = moe_lm.diff_leaves(self.c, self.t["grad_diff_leaves"])
        self.dev = torch.device(device)
        self.tokens_per_step = self.t["batch"] * self.t["seq"]
        self.attempted = 0
        self.window_losses: List[torch.Tensor] = []

    def setup(self) -> None:
        from repro_torch.launch import train as launch
        from repro_torch.launch.mesh import make_host_mesh
        from repro_torch.models.model import init_params, make_trainable
        from repro_torch.optim import adamw

        o = self.c["optimizer"]
        t0 = time.perf_counter()
        self.plan_dir = tempfile.mkdtemp(prefix="bench-plans-")
        args = launch.parse_args([
            "--arch", self.c["program_arch"], "--device", self.dev.type,
            "--batch", str(self.t["batch"]), "--seq", str(self.t["seq"]),
            "--lr", str(o["lr"]), "--steps", str(o["total_steps"]),
            "--plan-cache", self.plan_dir,
            "--plan-candidates", str(self.t["plan_candidates"])])
        self.s = launch.setup(args, cfg=program_config(self.c),
                              mesh=make_host_mesh(self.dev))
        t1 = time.perf_counter()
        model = init_params(None, self.s.cfg, device="meta")
        model.load_state_dict(moe_lm.make_weights(self.c, self.seed,
                                                  self.dev),
                              strict=True, assign=True)
        params = make_trainable(model)
        self.state = (params, adamw.init(params), None)
        self.feed = moe_lm.make_batches(self.c, self.t, self.seed, self.dev)
        _sync(self.dev)
        t2 = time.perf_counter()
        self.readings = self._checked_steps(o)
        self.setup_split = {"planning": t1 - t0, "weights and state": t2 - t1,
                            "checked steps": time.perf_counter() - t2}

    def _checked_steps(self, o: Dict) -> Dict:
        """The first steps, through the window's own call and feed: each
        step's loss, each leaf's first clipped gradient from AdamW's first
        moment after one step (its norm, and the gradient itself of the
        leaves the cell compares element by element, on the host), each
        leaf's change after the last."""
        losses, first, first_grads = [], {}, {}
        for i in range(CHECKED_STEPS):
            self.state, m = self.s.step_fn(self.state, next(self.feed))
            losses.append(float(m["loss"]))
            if i == 0:
                mu = self.state[1].mu
                first = {n: float(torch.linalg.vector_norm(x)) / (1 - o["b1"])
                         for n, x in mu.items()}
                first_grads = moe_lm.first_moment_grads(mu, self.keep,
                                                        o["b1"])
        weights = dict(self.state[0].named_parameters())
        return {"losses": losses, "first_grad_norms": first,
                "first_grads": first_grads,
                "change_norms": moe_lm.change_norms(
                    self.c, self.seed, {n: w.detach()
                                        for n, w in weights.items()})}

    def step(self):
        self.state, m = self.s.step_fn(self.state, next(self.feed))
        return m

    def window(self, seconds: float) -> Dict:
        _sync(self.dev)
        t0 = time.perf_counter()
        n = 0
        while True:
            self.window_losses.append(self.step()["loss"])
            n += 1
            if time.perf_counter() - t0 >= seconds:
                break
        _sync(self.dev)
        elapsed = time.perf_counter() - t0
        self.attempted = n
        return {"seconds": elapsed, "steps": n,
                "tokens": n * self.tokens_per_step,
                "flops": n * train_flops(self.c, self.t["batch"],
                                         self.t["seq"])}

    def trace_body(self, step_s: float):
        def body():
            for _ in range(TRACED_STEPS):
                self.step()
        return body, None, TRACED_STEPS

    def release(self) -> None:
        from repro_torch.models import shard_ctx
        from repro_torch.obs import set_tracer
        failed = sum(not math.isfinite(float(x)) for x in self.window_losses)
        self.window_failed = failed
        self.window_losses = []
        shard_ctx.set_gemm_context(None)
        set_tracer(None)
        self.state = self.s = self.feed = None
        shutil.rmtree(getattr(self, "plan_dir", ""), ignore_errors=True)
        gc.collect()
        if self.dev.type == "cuda":
            torch.cuda.empty_cache()

    def reference_readings(self, precision: str = "float32",
                           rows=None) -> Dict:
        """The reference over the same weights and first batches."""
        weights = moe_lm.make_weights(self.c, self.seed, self.dev)
        feed = moe_lm.make_batches(self.c, self.t, self.seed, self.dev)
        batches = [next(feed) for _ in range(CHECKED_STEPS)]
        out = moe_lm.train(self.c, self.c["optimizer"], weights, batches,
                           precision, rows, self.keep)
        out["change_norms"] = moe_lm.change_norms(self.c, self.seed, weights)
        del weights, batches
        gc.collect()
        if self.dev.type == "cuda":
            torch.cuda.empty_cache()
        return out

    def check(self, limits: Dict[str, float]) -> tuple:
        """The cell's limits name the numbers compared; the other readings
        go to standard error."""
        gaps = moe_lm.compare(self.readings, self.reference_readings())
        self.leaf_gaps = gaps.pop("grad_diff_by_leaf")
        checks = [Check(k, gaps[k], limits[k], WHAT[k]) for k in limits]
        for k in sorted(set(gaps) - set(limits)):
            print(f"reading {k}: {gaps[k]!r} (not compared): {WHAT[k]}",
                  file=sys.stderr, flush=True)
        return checks, self.window_failed


WHAT = {"loss_gap": f"largest relative gap of the first {CHECKED_STEPS} "
                    f"steps' losses",
        "grad_norm_gap": "worst leaf's gap of first clipped-gradient norms, "
                         "over the larger of its and the median leaf's "
                         "reference norm",
        "change_norm_gap": f"worst leaf's gap of the norms of its change over "
                           f"{CHECKED_STEPS} steps, likewise",
        "grad_diff": "worst leaf's |program's - reference's first clipped "
                     "gradient| over |reference's|, of the leaves the cell "
                     "names"}


def _sync(dev) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
