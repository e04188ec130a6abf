"""Device milliseconds a train step spends in the kernels under the MoE
layer's `moe.einsums` scope (forward and its recomputation)."""
from bench.metrics import _common


def read(run):
    w = run.host_window
    if w is None or not run.traced_units:
        return None
    us = w.scope_us()
    if not us["moe"] or not _common.attributed(us):
        return None
    return us["moe"] / 1e3 / run.traced_units
