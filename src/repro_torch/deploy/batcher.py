"""Shape-bucket-aware continuous batching for the serving harness (jax-free).

Live traffic hands the server a ragged stream of requests; every admission
decision fixes the M dimension of the batched GEMMs the model stack will
dispatch. A naive batcher admits whatever is pending and fragments the shape
stream into a long tail of M values — each one a cold `plan_cached` miss
(online analytic tune) plus a fresh XLA compile. The bucket-aware policy
admits so that M always lands on a warmed pow-2 bucket
(`deploy/bucketing.py`'s canonical tuning shapes): request groups are chosen
to maximize bucket fill, decode batches are padded up to the next pow-2, and
every dispatch stays on the pre-tuned, pre-compiled pool.

Pieces:

- `Request` — one traffic-trace entry (tenant, arrival, prompt/gen lengths,
  SLO deadline). Produced by `launch/traffic.py`'s seeded generator.
- `Batch` — one admitted unit of work: the requests, the actual token rows,
  and the GEMM M the engine will run (`m == rows` under FIFO; the padded
  pow-2 bucket under the bucket policy; `utilization` is the fill ratio).
- `BatchPolicy` — admission knobs: `mode` ("bucket" | "fifo"), `max_batch`,
  the `min_fill` a bucket-mode batch should reach before admission, and the
  `max_wait_s` aging bound after which the oldest request is admitted
  regardless (the no-starvation guarantee).
- `ContinuousBatcher` — per-tenant FIFO queues with oldest-head-first tenant
  selection. Invariants (tests/test_serving.py asserts them, hypothesis
  included): every submitted request is admitted exactly once, admission
  order within a tenant is arrival order, and no tenant starves (the tenant
  with the oldest waiting head request is always served next).
- `decode_m` / `bucket_pool` — the decode-side bucket rule and the warmed
  pow-2 M pool a harness should pre-tune (see docs/serving.md).
"""
from __future__ import annotations

import collections
import dataclasses
import math
from typing import Deque, Dict, List, Optional, Tuple

from repro_torch.deploy.bucketing import next_pow2

BATCH_MODES = ("bucket", "fifo")


@dataclasses.dataclass(frozen=True)
class Request:
    """One serving request of the replayed trace."""
    rid: int
    tenant: str
    arrival_s: float
    prompt_len: int
    gen_len: int
    # total-latency SLO, relative to arrival (TTFT + decode budget); inf
    # means best-effort. The harness derives it from the tenant spec.
    slo_s: float = math.inf

    @property
    def tokens(self) -> int:
        return self.prompt_len + self.gen_len

    @property
    def deadline_s(self) -> float:
        return self.arrival_s + self.slo_s


@dataclasses.dataclass(frozen=True)
class Batch:
    """One admitted unit of engine work (a batched prefill or decode round).

    `rows` is the real token-row count (sum of prompt lengths for prefill,
    active sequence count for decode); `m` is the GEMM M dimension the
    engine runs — equal to `rows` under FIFO, the padded pow-2 bucket under
    the bucket policy.
    """
    tenant: str
    phase: str                    # "prefill" | "decode"
    requests: Tuple[Request, ...]
    rows: int
    m: int

    @property
    def utilization(self) -> float:
        """Useful fraction of the admitted GEMM's M rows (1.0 = no pad)."""
        return self.rows / self.m if self.m else 0.0


@dataclasses.dataclass(frozen=True)
class BatchPolicy:
    """Admission knobs for the continuous batcher."""
    mode: str = "bucket"          # "bucket" | "fifo" (the naive baseline)
    # most requests one prefill batch / decode round may serve.
    max_batch: int = 8
    # bucket mode: don't admit a batch filling its bucket below this ratio
    # while the oldest pending request is younger than `max_wait_s` — wait
    # for more arrivals instead. FIFO mode ignores it (admit immediately).
    min_fill: float = 0.75
    # aging bound: once the oldest pending request has waited this long the
    # best available batch is admitted regardless of fill (no starvation).
    max_wait_s: float = 0.05
    # pow-2 saturation cap for padded Ms (mirrors BucketingPolicy.dim_cap).
    dim_cap: int = 8192

    def __post_init__(self) -> None:
        if self.mode not in BATCH_MODES:
            raise ValueError(f"mode must be one of {BATCH_MODES}, "
                             f"got {self.mode!r}")
        if not 0.0 < self.min_fill <= 1.0:
            raise ValueError(f"min_fill must be in (0, 1], got {self.min_fill}")

    def bucket_m(self, rows: int) -> int:
        """The padded pow-2 GEMM M for `rows` token rows."""
        return min(next_pow2(max(1, rows)), self.dim_cap)


def decode_m(n_active: int, policy: BatchPolicy) -> int:
    """GEMM M of one decode round over `n_active` sequences: the exact count
    under FIFO, the padded pow-2 bucket under the bucket policy."""
    if policy.mode == "fifo":
        return n_active
    return policy.bucket_m(n_active)


def bucket_pool(max_rows: int, policy: BatchPolicy) -> List[int]:
    """Every M the bucket policy can emit for workloads up to `max_rows`
    token rows: the pow-2 ladder 1..bucket_m(max_rows). This is the pool a
    harness warms (and pre-compiles) so bucket-mode admission never leaves
    tuned plans."""
    top = policy.bucket_m(max_rows)
    return [1 << i for i in range(top.bit_length())]


class ContinuousBatcher:
    """Per-tenant FIFO queues + bucket-aware (or naive) admission."""

    def __init__(self, policy: BatchPolicy = BatchPolicy()) -> None:
        self.policy = policy
        self._queues: Dict[str, Deque[Request]] = {}
        self._order: List[str] = []          # tenant registration order
        self.submitted = 0
        self.admitted = 0

    # -- intake --------------------------------------------------------------

    def submit(self, req: Request) -> None:
        q = self._queues.get(req.tenant)
        if q is None:
            q = self._queues[req.tenant] = collections.deque()
            self._order.append(req.tenant)
        q.append(req)
        self.submitted += 1

    def pending(self) -> int:
        return sum(len(q) for q in self._queues.values())

    def oldest_arrival(self) -> Optional[float]:
        heads = [q[0].arrival_s for q in self._queues.values() if q]
        return min(heads) if heads else None

    def next_decision_s(self) -> Optional[float]:
        """The virtual time at which a currently-declined admission becomes
        forced by aging (None when nothing is pending)."""
        oldest = self.oldest_arrival()
        return None if oldest is None else oldest + self.policy.max_wait_s

    # -- admission -----------------------------------------------------------

    def _pick_tenant(self) -> Optional[str]:
        """Tenant with the oldest waiting head request (ties broken by
        registration order) — the no-starvation rule."""
        best = None
        for name in self._order:
            q = self._queues[name]
            if q and (best is None
                      or q[0].arrival_s < self._queues[best][0].arrival_s):
                best = name
        return best

    def _best_prefix(self, q: Deque[Request]) -> Tuple[int, int, int]:
        """(k, rows, m) of the admission prefix the policy picks from `q`.

        FIFO: everything up to `max_batch`, exact rows. Bucket: the FIFO
        prefix (order within a tenant is never reordered) whose padded
        pow-2 bucket is best filled — ties go to the larger batch.
        """
        limit = min(len(q), self.policy.max_batch)
        if self.policy.mode == "fifo":
            rows = sum(q[i].prompt_len for i in range(limit))
            return limit, rows, max(1, rows)
        best = None                 # (k, rows, m, utilization)
        rows = 0
        for k in range(1, limit + 1):
            rows += q[k - 1].prompt_len
            m = self.policy.bucket_m(rows)
            util = rows / m
            if best is None or util >= best[3]:
                best = (k, rows, m, util)
        return best[0], best[1], best[2]

    def next_prefill(self, now: float) -> Optional[Batch]:
        """The next prefill batch to run at virtual time `now`, or None.

        None means either nothing is pending, or the bucket policy prefers
        to wait for a better fill (only while the oldest pending request is
        younger than `max_wait_s` — `next_decision_s` says when the engine
        should ask again).
        """
        tenant = self._pick_tenant()
        if tenant is None:
            return None
        q = self._queues[tenant]
        k, rows, m = self._best_prefix(q)
        if self.policy.mode == "bucket" and rows / m < self.policy.min_fill \
                and now - q[0].arrival_s < self.policy.max_wait_s:
            return None
        reqs = tuple(q.popleft() for _ in range(k))
        self.admitted += len(reqs)
        return Batch(tenant=tenant, phase="prefill", requests=reqs,
                     rows=rows, m=m)
