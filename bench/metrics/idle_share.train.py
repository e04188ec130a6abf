"""Percent of the profiled sub-window with the device idle (train cell)."""
from bench.metrics import _common


def read(run):
    return _common.idle_share(run)
