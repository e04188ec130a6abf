"""Deployed GEMM throughput: every call's 2 M N K FLOPs completed in the
window over its seconds, in TFLOP/s."""
from bench.metrics import _common


def read(run):
    return _common.per_second(run, "flops", 1e12)
