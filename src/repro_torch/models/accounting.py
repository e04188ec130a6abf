"""FLOP/byte accounting mode for the dry run's roofline extraction.

Port of `repro/models/accounting.py`. The reference measures reduced-depth
configs (1 and 2 layer units) with every scan unrolled, because XLA's
cost_analysis counts a while-loop body once, and extrapolates linearly:
F(L) = F(1) + (L - 1) * (F(2) - F(1)). `launch/dryrun.py` does the same
here, for the per-unit terms, on the meta device.

Eager PyTorch already runs every loop in Python, so the reference's unroll
switches (`UNROLL_LAYERS`, `SCAN_UNROLL`) and its `scan` have nothing to
do here and are not kept. `accounting_mode(seq_len)` sets the one switch
that changes what is counted, `CHUNK_OVERRIDE`, and restores it on exit:
it enlarges the chunk of `chunked_sdpa` and of the chunked SSD and mLSTM
forms in `models/ssm.py` to max(128, seq_len // MAX_UNROLL_STEPS) (fewer,
larger attention blocks; the SSD's chunk-local terms). The sLSTM's time
loop runs every step in the port's trace, so its FLOPs need no analytic
correction.
"""
from __future__ import annotations

import contextlib

CHUNK_OVERRIDE = None          # chunk length for attention/SSD in accounting
MAX_UNROLL_STEPS = 8           # cap on unrolled inner-scan bodies


@contextlib.contextmanager
def accounting_mode(seq_len: int):
    global CHUNK_OVERRIDE
    prev = CHUNK_OVERRIDE
    CHUNK_OVERRIDE = max(128, seq_len // MAX_UNROLL_STEPS)
    try:
        yield
    finally:
        CHUNK_OVERRIDE = prev


def chunk(default: int) -> int:
    return CHUNK_OVERRIDE if CHUNK_OVERRIDE is not None else default
