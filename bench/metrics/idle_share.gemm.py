"""Percent of the profiled sub-window with the device idle (m4096 cells)."""
from bench.metrics import _common


def read(run):
    return _common.idle_share(run)
