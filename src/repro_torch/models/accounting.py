"""Chunk-length override of the FLOP/byte accounting mode.

Port of the part of `repro/models/accounting.py` that the model stack
reads: `chunk(default)`, the chunk length of `chunked_sdpa` and of the
chunked SSD and mLSTM forms in `models/ssm.py`, and `CHUNK_OVERRIDE`,
which replaces it while accounting. The accounting mode
itself (`accounting_mode`, layer unrolling and the unrolled scans) waits
for `launch/dryrun` (ROADMAP.md, queue 1: the dry-run launchers);
eager PyTorch runs every loop as Python, so nothing here needs unrolling.
"""
from __future__ import annotations

CHUNK_OVERRIDE = None          # chunk length for attention and the scans


def chunk(default: int) -> int:
    return CHUNK_OVERRIDE if CHUNK_OVERRIDE is not None else default
