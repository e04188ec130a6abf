"""Percent of the routed (token, choice) pairs that MoE capacity dropped in
the traced steps (the program's `moe.dropped` over `moe.pairs`)."""
from bench.metrics import _scopes


def read(run):
    return _scopes.moe_dropped(run)
