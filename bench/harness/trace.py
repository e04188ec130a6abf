"""The profiled sub-window of a traced run, and what the per-layer readers
take from it.

The window is padded as the port's `chip_smoke.device_profile` pads its
own: a device-only window synchronized at both ends does not always hold
every kernel the card ran in it (on an H100 5 of 8 windows lost some of
their first kernels, `tools/profile_edge_probe.py`), so the work runs
between a host pause and a run of spin kernels at each edge, and a window
whose profile kept none of the spin kernels at an edge is run again.
"""
from __future__ import annotations

import contextlib
import time
from typing import Callable, Dict, List, Tuple

import numpy as np

PROFILE_EDGE_S, PROFILE_EDGE_KERNELS = 0.25, 1000
SPIN_KERNEL = "spin_kernel"             # what torch.cuda._sleep launches
ATTEMPTS = 3
BREAKDOWN_ENTRIES = 10
LABELLED_GAPS = 400                     # the longest gaps given a host label

# the program's profiler scopes the readers attribute device time to
GEMM_SCOPE = "dit_gemm."                # `core/gemm.py`: dit_gemm.<mode>
MOE_SCOPE = "moe.einsums"               # `models/moe.py`
BACKWARD_NODE = "LocalMatmulBackward"   # `kernels/ops.py`: _LocalMatmul


class TraceLost(RuntimeError):
    """The profile kept none of a window's spin kernels at an edge."""


@contextlib.contextmanager
def padded_window(torch, dev, host: bool):
    acts = [torch.profiler.ProfilerActivity.CUDA]
    if host:
        acts.append(torch.profiler.ProfilerActivity.CPU)
    torch.cuda.synchronize(dev)
    with torch.profiler.profile(activities=acts) as prof:
        time.sleep(PROFILE_EDGE_S)
        for _ in range(PROFILE_EDGE_KERNELS):
            torch.cuda._sleep(100)
        yield prof
        for _ in range(PROFILE_EDGE_KERNELS):
            torch.cuda._sleep(100)
        torch.cuda.synchronize(dev)
        time.sleep(PROFILE_EDGE_S)


class Kernel:
    __slots__ = ("name", "start", "end")

    def __init__(self, name: str, start: float, end: float):
        self.name, self.start, self.end = name, start, end


class Window:
    """The device operations of one profiled window between its edge
    kernels (times in microseconds), and with `host`, the host's events."""

    def __init__(self, prof, host: bool):
        from torch.autograd import DeviceType
        events = list(prof.events())
        annotations = {e.name for e in events
                       if e.device_type == DeviceType.CPU
                       and getattr(e, "is_user_annotation", False)}
        ops = sorted((Kernel(e.name, e.time_range.start, e.time_range.end)
                      for e in events
                      if e.device_type == DeviceType.CUDA
                      and not getattr(e, "is_user_annotation", False)
                      and e.name not in annotations
                      and not e.name.startswith(GEMM_SCOPE)),
                     key=lambda k: k.start)
        work = [i for i, k in enumerate(ops) if SPIN_KERNEL not in k.name]
        if not work:
            raise TraceLost("the profiled window holds no device work")
        lead, trail = work[0], len(ops) - 1 - work[-1]
        if not (lead and trail):
            raise TraceLost(f"the profile kept {lead} leading and {trail} "
                            f"trailing of its {PROFILE_EDGE_KERNELS} edge "
                            f"kernels")
        self.kernels = [k for k in ops[work[0]:work[-1] + 1]
                        if SPIN_KERNEL not in k.name]
        self.start = self.kernels[0].start
        self.end = max(k.end for k in self.kernels)
        self.busy, self.gaps = _union(self.kernels)
        self.host = host
        self.annotations = annotations
        self.cpu = ([e for e in events if e.device_type == DeviceType.CPU]
                    if host else [])

    @property
    def window_us(self) -> float:
        return self.end - self.start

    def device_ops(self, n: int = BREAKDOWN_ENTRIES
                   ) -> List[Tuple[str, float]]:
        """The device operations that took most time, by name, seconds."""
        by_name: Dict[str, float] = {}
        for k in self.kernels:
            by_name[k.name] = by_name.get(k.name, 0.0) + (k.end - k.start)
        top = sorted(by_name.items(), key=lambda kv: -kv[1])[:n]
        return [[name, us / 1e6] for name, us in top]

    def idle_gaps(self, n: int = BREAKDOWN_ENTRIES
                  ) -> List[Tuple[str, float]]:
        """The longest idle gaps, summed by what the host was doing at
        each gap's middle (the innermost host op that spans it), seconds.
        Needs a window traced with host activity."""
        if not self.host or not self.gaps:
            return []
        starts = np.array([e.time_range.start for e in self.cpu])
        ends = np.array([e.time_range.end for e in self.cpu])
        by_label: Dict[str, float] = {}
        for g0, g1 in sorted(self.gaps, key=lambda g: g[0] - g[1]
                             )[:LABELLED_GAPS]:
            mid = 0.5 * (g0 + g1)
            hit = np.nonzero((starts <= mid) & (ends >= mid))[0]
            if len(hit):
                inner = hit[np.argmin(ends[hit] - starts[hit])]
                label = self.cpu[inner].name
            else:
                label = "host: no traced op"
            by_label[label] = by_label.get(label, 0.0) + (g1 - g0)
        top = sorted(by_label.items(), key=lambda kv: -kv[1])[:n]
        return [[name, us / 1e6] for name, us in top]

    def scope_us(self) -> Dict[str, float]:
        """Device microseconds of the window's kernels by the program's
        scope whose span, on the launching thread, holds the kernel's
        launch, the innermost first: `gemm` in a `dit_gemm.<mode>` scope;
        `moe` in `moe.einsums`; `backward` in the routed matmul's autograd
        node (`_LocalMatmulBackward`) and launched after the last of the
        scopes nested in that node, which are the layer's recomputation
        that the node's first saved tensor sets off (`recompute` for the
        rest of it); `other`. The launch is the host event that the
        profile ties the kernel to, found by time and thread, so no
        parent links between host events are needed; `total` is the sum of
        the window's kernels, which the categories add up to. Needs a
        window traced with host activity."""
        if not self.host:
            return {}
        scopes: Dict[int, List] = {}
        nodes: Dict[int, List] = {}
        for e in self.cpu:
            r = (e.time_range.start, e.time_range.end)
            if e.name.startswith(GEMM_SCOPE):
                scopes.setdefault(e.thread, []).append(r + ("gemm",))
            elif e.name == MOE_SCOPE:
                scopes.setdefault(e.thread, []).append(r + ("moe",))
            elif e.name.endswith(BACKWARD_NODE):
                nodes.setdefault(e.thread, []).append(list(r) + [-1.0])
        for th, ns in nodes.items():
            for n in ns:
                n[2] = max((end for start, end, _ in scopes.get(th, [])
                            if n[0] <= start and end <= n[1]), default=-1.0)
        out = {"gemm": 0.0, "moe": 0.0, "backward": 0.0, "recompute": 0.0,
               "other": 0.0}
        for e in self.cpu:
            if e.name.startswith("cu"):
                # a runtime call's copy of its op's kernels (torch 2.11
                # ties a kernel to both): counted with the op
                continue
            us = sum(k.duration for k in e.kernels
                     if SPIN_KERNEL not in k.name
                     and k.name not in self.annotations
                     and not k.name.startswith(GEMM_SCOPE))
            if not us:
                continue
            t = e.time_range.start
            inside = [(end - start, cat) for start, end, cat
                      in scopes.get(e.thread, []) if start <= t <= end]
            if inside:
                out[min(inside)[1]] += us
                continue
            holders = [(n[1] - n[0], n[2]) for n in nodes.get(e.thread, [])
                       if n[0] <= t <= n[1]]
            if holders:
                out["recompute" if t < min(holders)[1] else "backward"] += us
            else:
                out["other"] += us
        out["total"] = sum(k.end - k.start for k in self.kernels)
        return out

    def scope_counts(self) -> Dict[str, int]:
        """How many `dit_gemm.<mode>` scopes and routed-matmul backward
        nodes the window's host ran (their outermost event each)."""
        gemm = node = 0
        for e in self.cpu:
            if e.name.startswith(GEMM_SCOPE):
                gemm += 1
            elif e.name.endswith(BACKWARD_NODE) and not (
                    e.cpu_parent is not None
                    and e.cpu_parent.name.endswith(BACKWARD_NODE)):
                node += 1
        return {"gemm_scopes": gemm, "backward_nodes": node}


def _union(kernels: List[Kernel]) -> Tuple[float, List[Tuple[float, float]]]:
    """(busy microseconds, idle gaps) of intervals sorted by start."""
    busy, gaps = 0.0, []
    cur0, cur1 = kernels[0].start, kernels[0].end
    for k in kernels[1:]:
        if k.start > cur1:
            busy += cur1 - cur0
            gaps.append((cur1, k.start))
            cur0, cur1 = k.start, k.end
        else:
            cur1 = max(cur1, k.end)
    busy += cur1 - cur0
    return busy, gaps


def traced(torch, dev, body: Callable[[], None], host: bool) -> Window:
    """Run `body` inside a padded profiled window and read it, running it
    again (up to `ATTEMPTS` windows) where the profile lost an edge."""
    for attempt in range(ATTEMPTS):
        with padded_window(torch, dev, host) as prof:
            body()
        try:
            return Window(prof, host)
        except TraceLost:
            if attempt == ATTEMPTS - 1:
                raise
    raise AssertionError("unreachable")
