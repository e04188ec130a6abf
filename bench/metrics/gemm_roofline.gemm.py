"""The GEMM calls' share of their roofline, in percent (m4096 cells)."""
from bench.metrics import _common


def read(run):
    return _common.gemm_roofline(run)
