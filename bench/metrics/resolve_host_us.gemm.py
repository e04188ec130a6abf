"""Median host microseconds of a call's plan resolution and lowering
(`gemm.resolve`: `Planner.plan` + `lower_for`) in the traced window."""
from bench.metrics import _scopes


def read(run):
    return _scopes.resolve_host_us(run)
