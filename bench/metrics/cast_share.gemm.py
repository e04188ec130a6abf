"""Percent of the traced window's kernel time spent in the cast of C to
the operand dtype (kernels launched inside `gemm.cast`)."""
from bench.metrics import _scopes


def read(run):
    return _scopes.cast_share(run)
