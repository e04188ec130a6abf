"""Readings the metric readers share."""
from __future__ import annotations

import statistics

from bench.harness.yardstick import (PEAK_FLOPS, backward_gemms,
                                     train_gemms)


def per_second(run, key: str, scale: float = 1.0):
    w = run.window
    if not w.get(key) or not w.get("seconds"):
        return None
    return w[key] / w["seconds"] / scale


def mfu(run, flops_key: str = "flops", dtype: str = None):
    """Percent of the data-sheet dense peak of the window's FLOPs over its
    seconds."""
    rate = per_second(run, flops_key)
    if rate is None:
        return None
    return 100.0 * rate / PEAK_FLOPS[dtype or run.window["dtype"]]


def dispatch_us(run):
    """Median host microseconds of a `dit_gemm` call while the launch queue
    had room."""
    return statistics.median(run.dispatch_us) if run.dispatch_us else None


def idle_share(run):
    """Percent of the device-only profiled sub-window covered by no device
    operation."""
    w = run.device_window
    if w is None or w.window_us <= 0:
        return None
    return 100.0 * (w.window_us - w.busy) / w.window_us


def gemm_roofline(run):
    """Percent: the traced calls' least times over the device time of every
    kernel of the device-only sub-window (each belongs to a call)."""
    w = run.device_window
    if w is None or not run.traced_gemms:
        return None
    device_us = sum(k.end - k.start for k in w.kernels)
    return 100.0 * sum(g.least_s for g in run.traced_gemms) * 1e6 / device_us


def train_roofline(run):
    """Percent: the traced steps' routed GEMM products' least times (each
    forward as often as the steps ran it, forward and recompute, and its
    two backward products once per backward node) over the device time of
    the kernels under the `dit_gemm.<mode>` scopes and the routed
    matmul's backward node. None where the scope counts are not whole
    multiples of the step's routed GEMMs."""
    w = run.host_window
    if w is None:
        return None
    t = run.cell["traffic"]
    forward = train_gemms(run.config, t["batch"], t["seq"],
                          run.config["loss_chunk"])
    counts = w.scope_counts()
    per = len(forward) * run.traced_units
    if not per or counts["gemm_scopes"] % per \
            or counts["backward_nodes"] % per:
        return None
    runs, nodes = counts["gemm_scopes"] // per, counts["backward_nodes"] // per
    least = run.traced_units * sum(
        runs * g.least_s + nodes * sum(b.least_s for b in backward_gemms(g))
        for g in forward)
    us = w.scope_us()
    device_us = us["gemm"] + us["backward"]
    if not device_us or not attributed(us):
        return None
    return 100.0 * least * 1e6 / device_us


def attributed(us) -> bool:
    """Whether the scopes' kernels add up to the window's, within 2 %: a
    profile that ties kernels to host events otherwise reads nothing."""
    parts = sum(v for k, v in us.items() if k != "total")
    return abs(parts - us["total"]) <= 0.02 * us["total"]
