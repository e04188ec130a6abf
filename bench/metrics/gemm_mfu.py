"""Percent of the operand dtype's dense peak reached by the window's GEMM
FLOPs (m4096 cells)."""
from bench.metrics import _common


def read(run):
    return _common.mfu(run)
