"""Traffic generator: a stream of deployed GEMMs through the port's entry.

Each call is `dit_gemm(a, w, mesh, planner=planner)` on the card's host
mesh: every call resolves its plan from the planner's cache and lowers it
for its operands, the way the port deploys a GEMM. A round is one call per
(m, (n, k)) of the cell, in order; rounds run back to back with no host
sync inside the window, which ends with one synchronize.

Operands are made on the device from the seed: each call has its own A
(m, k) and its own weight, stored (n, k) as DeepGEMM and `nn.Linear` hold
it and handed as its (k, n) view (K-major); in e4m3 or bf16 as the
traffic says. C is what `dit_gemm` returns. Plans are tuned in set-up into
a fresh cache under the run's temporary directory.

The outputs of a few rounds, drawn from the seed while the window runs,
are kept and held to the exact product once the window has closed.
"""
from __future__ import annotations

import math
import random
import shutil
import tempfile
import time
from typing import Dict, List

import torch

from bench.harness.core import Check, derive_seed
from bench.harness.yardstick import Gemm, gemm_round
from bench.reference import gemm as ref

DTYPES = {"float8_e4m3fn": torch.float8_e4m3fn, "bfloat16": torch.bfloat16}
SAMPLED_ROUNDS = 3          # rounds whose C is kept and checked
DISPATCH_ROUNDS = 20        # rounds timed call by call after a synchronize
TRACE_SECONDS = 0.3         # the profiled sub-window's length, about


class Traffic:
    kind = "gemm"

    def __init__(self, cell: Dict, config: Dict, seed: int, device):
        t = cell["traffic"]
        self.seed = seed
        self.dev = torch.device(device)
        self.ms: List[int] = list(t["m"])
        self.nk: List[List[int]] = [list(x) for x in config["gemms"]]
        self.dtype_name = t["dtype"]
        self.dtype = DTYPES[self.dtype_name]
        self.scale = float(t["operand_scale"])
        self.candidates = int(t["plan_candidates"])
        self.round: List[Gemm] = gemm_round(self.ms, self.nk, self.dtype_name)
        self.calls = []          # (a, w view) per call of a round
        self.kept: List[List[torch.Tensor]] = []
        self.attempted = 0

    # ---------------------------------------------------------------- set-up
    def setup(self) -> None:
        from repro_torch.core.gemm import dit_gemm
        from repro_torch.core.schedule import GEMMShape
        from repro_torch.deploy.cache import PlanCache
        from repro_torch.deploy.planner import Planner
        from repro_torch.deploy.warmup import plan_view
        from repro_torch.launch.mesh import make_host_mesh

        t0 = time.perf_counter()
        self.dit_gemm = dit_gemm
        self.mesh = make_host_mesh(self.dev)
        self.plan_dir = tempfile.mkdtemp(prefix="bench-plans-")
        self.planner = Planner(plan_view((1, 1), mesh=self.mesh),
                               cache=PlanCache(self.plan_dir),
                               elem_bytes=torch.empty(
                                   (), dtype=self.dtype).element_size(),
                               max_candidates=self.candidates)
        for g in self.round:
            self.planner.plan(GEMMShape(g.m, g.n, g.k), allow_bucketed=False)
        t1 = time.perf_counter()
        gen = torch.Generator(device=self.dev)
        for i, g in enumerate(self.round):
            gen.manual_seed(derive_seed(self.seed, f"gemm.{i}"))
            a = self._operand((g.m, g.k), gen)
            w = self._operand((g.n, g.k), gen)
            self.calls.append((a, w.T))
        _sync(self.dev)
        t2 = time.perf_counter()
        self._round()                           # every shape, once
        _sync(self.dev)
        self.setup_split = {"planning": t1 - t0, "operands": t2 - t1,
                            "warm-up": time.perf_counter() - t2}

    def _operand(self, shape, gen) -> torch.Tensor:
        """Unit normals times the traffic's scale, drawn on the device and
        rounded to the operand dtype."""
        x = torch.randn(shape, generator=gen, device=self.dev)
        return x.mul_(self.scale).to(self.dtype)

    def _call(self, a, w):
        return self.dit_gemm(a, w, self.mesh, planner=self.planner)

    def _round(self) -> List[torch.Tensor]:
        return [self._call(a, w) for a, w in self.calls]

    # ---------------------------------------------------------------- window
    def window(self, seconds: float) -> Dict:
        """Rounds back to back until `seconds` have passed on the host
        clock, then one synchronize; a reservoir drawn from the seed keeps
        the outputs of `SAMPLED_ROUNDS` rounds."""
        pick = random.Random(derive_seed(self.seed, "sampled rounds"))
        kept: List = []
        _sync(self.dev)
        t0 = time.perf_counter()
        n = 0
        while True:
            outs = self._round()
            if n < SAMPLED_ROUNDS:
                kept.append(outs)
            else:
                j = pick.randrange(n + 1)
                if j < SAMPLED_ROUNDS:
                    kept[j] = outs
            n += 1
            if time.perf_counter() - t0 >= seconds:
                break
        _sync(self.dev)
        elapsed = time.perf_counter() - t0
        self.kept = kept
        self.attempted = n * len(self.round)
        return {"seconds": elapsed, "rounds": n, "calls": self.attempted,
                "flops": n * sum(g.flops for g in self.round),
                "bytes": n * sum(g.bytes for g in self.round),
                "dtype": self.dtype_name}

    # ---------------------------------------------------------------- traced
    def dispatch_us(self) -> List[float]:
        """Host microseconds of each call of `DISPATCH_ROUNDS` rounds, each
        round right after a synchronize, so the launch queue has room and
        no call waits on the card."""
        samples = []
        for _ in range(DISPATCH_ROUNDS):
            _sync(self.dev)
            for a, w in self.calls:
                t0 = time.perf_counter()
                self._call(a, w)
                samples.append((time.perf_counter() - t0) * 1e6)
        _sync(self.dev)
        return samples

    def trace_body(self, round_s: float):
        """The profiled sub-window's work: about `TRACE_SECONDS` of rounds,
        and the GEMMs they run."""
        rounds = max(1, math.ceil(TRACE_SECONDS / max(round_s, 1e-6)))

        def body():
            for _ in range(rounds):
                self._round()
        return body, self.round * rounds, rounds

    # ---------------------------------------------------------------- check
    def release(self) -> None:
        shutil.rmtree(getattr(self, "plan_dir", ""), ignore_errors=True)
        self.planner = None

    def check(self, limits: Dict[str, float]) -> tuple:
        """Each kept C against the exact product of its operands: the
        largest gap over the root mean square of the exact C, the worst
        over every kept call."""
        errs = [ref.c_error(out, a, w) for outs in self.kept
                for (a, w), out in zip(self.calls, outs)]
        failed = sum(not e <= limits["c_err"] for e in errs)
        worst = max(errs) if all(map(math.isfinite, errs)) else math.nan
        rounds = len(self.kept)
        return [Check("c_err", worst, limits["c_err"],
                      f"largest |C - exact A@B| over rms(exact C), worst of "
                      f"{rounds} kept rounds x {len(self.calls)} calls")], \
            failed


def _sync(dev) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
