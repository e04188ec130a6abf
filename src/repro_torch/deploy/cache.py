"""PlanCache: persistent store of DeploymentPlans.

Keys are `(shape, elem_bytes, hw fingerprint, search variant)` — the exact
identity of a tuning problem. The cache is an in-memory dict backed (optionally) by a
directory of one-JSON-file-per-plan, so a warmed cache survives process
restarts and can be shipped alongside a model as a deployment artifact.

Invalidation is by construction: the hardware fingerprint is part of the
key, so plans tuned for a different `AcceleratorConfig` (or written by an
incompatible schema version) are never served — stale files are simply
ignored on load.
"""
from __future__ import annotations

import dataclasses
import json
import os
import tempfile
from typing import Dict, Iterator, List, Optional, Tuple

from repro_torch.core.schedule import GEMMShape
from repro_torch.hw.config import AcceleratorConfig

from repro_torch.deploy.plan import DeploymentPlan, hw_fingerprint

# (m, n, k, elem_bytes, hw_digest, variant) — variant tags a restricted
# search space ("" = unrestricted) so constrained tunes never collide with
# the unrestricted winner for the same shape. Attention shapes keep the
# 6-slot arity (iterators unpack keys positionally) but discriminate by a
# string first slot encoding the full AttnShape geometry.
Key = Tuple[object, int, int, int, str, str]


def plan_key(shape, elem_bytes: int, hw_digest: str,
             variant: str = "") -> Key:
    if hasattr(shape, "skv"):       # AttnShape
        tag = (f"attn_b{shape.b}_q{shape.sq}_kv{shape.skv}"
               f"_h{shape.h}x{shape.hkv}_d{shape.d}v{shape.dv}"
               f"_c{int(shape.causal)}")
        return (tag, 0, 0, elem_bytes, hw_digest, variant)
    return (shape.m, shape.n, shape.k, elem_bytes, hw_digest, variant)


def _filename(key: Key) -> str:
    m, n, k, eb, digest, variant = key
    tag = f"_v{variant}" if variant else ""
    head = m if isinstance(m, str) else f"m{m}_n{n}_k{k}"
    return f"{head}_e{eb}_{digest}{tag}.plan.json"


@dataclasses.dataclass
class CacheStats:
    hits: int = 0
    misses: int = 0
    puts: int = 0

    def describe(self) -> str:
        total = self.hits + self.misses
        rate = self.hits / total if total else 0.0
        return f"hits={self.hits} misses={self.misses} hit-rate={rate:.0%}"


class PlanCache:
    """In-memory plan store with optional on-disk persistence."""

    def __init__(self, cache_dir: Optional[str] = None):
        self.cache_dir = cache_dir
        self._mem: Dict[Key, DeploymentPlan] = {}
        self.stats = CacheStats()
        if cache_dir:
            os.makedirs(cache_dir, exist_ok=True)
            self._load_dir()

    def _load_dir(self) -> None:
        for fname in sorted(os.listdir(self.cache_dir)):
            if not fname.endswith(".plan.json"):
                continue
            path = os.path.join(self.cache_dir, fname)
            try:
                with open(path) as f:
                    plan = DeploymentPlan.from_json(f.read())
            except (ValueError, KeyError, TypeError, OSError,
                    json.JSONDecodeError):
                continue   # corrupt, incompatible-schema, or unreadable file
            s = plan.shape
            key = plan_key(s, plan.elem_bytes, plan.hw_digest, plan.variant)
            self._mem[key] = plan

    # -- core API -----------------------------------------------------------

    def get(self, shape: GEMMShape, elem_bytes: int,
            hw: AcceleratorConfig,
            variant: str = "") -> Optional[DeploymentPlan]:
        plan = self.peek(shape, elem_bytes, hw, variant)
        if plan is None:
            self.stats.misses += 1
        else:
            self.stats.hits += 1
        return plan

    def peek(self, shape: GEMMShape, elem_bytes: int,
             hw: AcceleratorConfig,
             variant: str = "") -> Optional[DeploymentPlan]:
        """Lookup without touching hit/miss stats (internal probes)."""
        return self._mem.get(
            plan_key(shape, elem_bytes, hw_fingerprint(hw), variant))

    def put(self, plan: DeploymentPlan) -> None:
        key = plan_key(plan.shape, plan.elem_bytes, plan.hw_digest,
                       plan.variant)
        self._mem[key] = plan
        self.stats.puts += 1
        if self.cache_dir:
            path = os.path.join(self.cache_dir, _filename(key))
            # atomic publish so a concurrent reader never sees a torn file
            fd, tmp = tempfile.mkstemp(dir=self.cache_dir, suffix=".tmp")
            try:
                with os.fdopen(fd, "w") as f:
                    f.write(plan.to_json())
                os.replace(tmp, path)
            except BaseException:
                if os.path.exists(tmp):
                    os.unlink(tmp)
                raise

    def contains(self, shape: GEMMShape, elem_bytes: int,
                 hw: AcceleratorConfig, variant: str = "") -> bool:
        """Membership check that does not perturb hit/miss stats."""
        key = plan_key(shape, elem_bytes, hw_fingerprint(hw), variant)
        return key in self._mem

    def shapes_for(self, elem_bytes: int, hw: AcceleratorConfig,
                   variant: str = "") -> Iterator[GEMMShape]:
        """Tuned shapes usable on `hw` — the bucketing layer's search pool."""
        digest = hw_fingerprint(hw)
        for (m, n, k, eb, d, v) in self._mem:
            if isinstance(m, str):
                continue        # attention plans are not bucketing seeds
            if eb == elem_bytes and d == digest and v == variant:
                yield GEMMShape(m, n, k)

    def plans(self) -> List[DeploymentPlan]:
        return list(self._mem.values())

    def clear(self) -> None:
        self._mem.clear()
        if self.cache_dir:
            for fname in os.listdir(self.cache_dir):
                if fname.endswith(".plan.json"):
                    os.unlink(os.path.join(self.cache_dir, fname))

    def __len__(self) -> int:
        return len(self._mem)
