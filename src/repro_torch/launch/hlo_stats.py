"""Collective counts and bytes of a traced step (the dry run's collective
term, §Roofline sources).

Port of `repro/launch/hlo_stats.py`. The reference parses XLA's compiled
HLO text: it sums the bytes of every all-gather / all-reduce /
reduce-scatter / all-to-all / collective-permute instruction, and scales
the ones inside while-loop bodies by a caller-supplied `loop_factor`,
since the text holds a loop body once. An eager PyTorch step has no HLO,
so `collective_stats(hlo, loop_factor)` and its parser (`_split_computations`,
`_shape_bytes`) have no counterpart here. The counts come instead from
the collectives themselves: every call of `core/collectives.py` into
`torch.distributed` reports its kind and its operand's bytes while
`record_collectives()` is open, forward and backward. Eager tracing runs
every loop iteration, so there is no loop factor to correct.

The bytes are each call's operand: the same as the reference's for an
all-reduce and a collective-permute, the local block for an all-gather
(the reference reads the instruction's result, the gathered tensor) and
the whole input for a reduce-scatter (the reference's result is one block
of it).
"""
from __future__ import annotations

import contextlib
import dataclasses
from typing import Dict, Iterator

from repro_torch.core import collectives

_COLLECTIVES = ("all-gather", "all-reduce", "reduce-scatter", "all-to-all",
                "collective-permute")


@dataclasses.dataclass
class CollectiveStats:
    bytes_by_kind: Dict[str, int]
    count_by_kind: Dict[str, int]

    @property
    def total_bytes(self) -> int:
        return sum(self.bytes_by_kind.values())

    def summary(self) -> str:
        parts = [f"{k}:{v/1e6:.1f}MB(x{self.count_by_kind[k]})"
                 for k, v in sorted(self.bytes_by_kind.items()) if v]
        return " ".join(parts) or "none"


@contextlib.contextmanager
def record_collectives() -> Iterator[CollectiveStats]:
    """Count every collective called inside the block: yields a
    `CollectiveStats` that fills as they run (every kind present, zero
    until one is seen)."""
    stats = CollectiveStats({k: 0 for k in _COLLECTIVES},
                            {k: 0 for k in _COLLECTIVES})

    def add(kind: str, nbytes: int) -> None:
        stats.bytes_by_kind[kind] += nbytes
        stats.count_by_kind[kind] += 1

    with collectives.recording(add):
        yield stats
