"""Readings of the program's own profiler scopes in the `--trace 1` host
window (`run.host_window`): the train step's phases, its host syncs, the
MoE einsums' backward and drops, and a routed GEMM call's cast, plan
resolution and `mmad` wrapper.

The scopes are `record_function` ranges the port enters while a profiler
runs (`repro_torch.obs.trace.profile_scope`): `train.step`,
`train.forward` (holding `train.loss`), `train.backward`, `optim.adamw`
(holding `optim.clip`), `gemm.resolve`, `gemm.cast`, `mmad.launch`,
`moe.einsums`. A kernel belongs to a scope when the scope's range holds
its launch: the host event the profile ties the kernel to, by its start
time, as `Window.scope_us` finds it. `train.backward` and `train.step`
hold launches of any thread, since the autograd engine launches the
backward from its own; the other scopes hold their own thread's. A
program without a scope reads nothing here (None).
"""
from __future__ import annotations

import bisect
import statistics
from typing import Dict, List, Optional, Tuple

from bench.harness import trace

STEP = "train.step"
# phase -> (scope, whether it holds launches of any thread)
PHASES = {"forward": ("train.forward", False),
          "backward": ("train.backward", True),
          "optimizer": ("optim.adamw", False)}
# a part of a phase -> (scope, the phase that holds it); launched on the
# phase's own thread
PARTS = {"loss": ("train.loss", "forward"),
         "clip": ("optim.clip", "optimizer")}
CAST, RESOLVE, MMAD = "gemm.cast", "gemm.resolve", "mmad.launch"
NODE = "autograd::engine::evaluate_function: "
# host calls that wait for the device (a synchronous `cudaMemcpy` too)
SYNC_CALLS = frozenset({"cudaStreamSynchronize", "cudaDeviceSynchronize",
                        "cudaEventSynchronize", "cudaMemcpy"})
# the CUDA kernel launch calls, of the runtime (`cudaLaunchKernel`,
# `cudaLaunchKernelExC`) and of the lower-level `cu*` API (`cuLaunchKernel`,
# `cuLaunchKernelEx`): where the launch queue is full the host waits inside
# them
LAUNCH_PREFIXES = ("cudaLaunch", "cuLaunch")


class Ranges:
    """Time ranges (start, end, thread), for asking which holds a time on
    a thread or on any. The ranges of one name do not overlap, on one
    thread or across threads (the host runs one step, one backward, one
    cast at a time)."""

    def __init__(self, ranges):
        self.all = sorted(ranges)
        self._starts = [r[0] for r in self.all]
        self.by_thread: Dict[int, List[Tuple[float, float]]] = {}
        for s, e, th in self.all:
            self.by_thread.setdefault(th, []).append((s, e))
        self._thread_starts = {th: [r[0] for r in rs]
                               for th, rs in self.by_thread.items()}

    @classmethod
    def of(cls, events) -> "Ranges":
        return cls([(e.time_range.start, e.time_range.end, e.thread)
                    for e in events])

    def __len__(self) -> int:
        return len(self.all)

    def holds(self, t: float, thread: int, any_thread: bool) -> bool:
        if any_thread:
            i = bisect.bisect_right(self._starts, t)
            return i > 0 and t <= self.all[i - 1][1]
        rs = self.by_thread.get(thread)
        if not rs:
            return False
        i = bisect.bisect_right(self._thread_starts[thread], t)
        return i > 0 and t <= rs[i - 1][1]


def scope_events(w, name: str) -> list:
    """The window's host events of a scope (the host side of the range)."""
    return [e for e in w.cpu if e.name == name]


def launches(w) -> List[Tuple[int, float, float]]:
    """(thread, launch time, device microseconds) of every host event the
    profile ties kernels to, the spin and annotation kernels left out, as
    `Window.scope_us` counts them."""
    out = []
    for e in w.cpu:
        if e.name.startswith("cu"):
            continue        # a runtime call's copy of its op's kernels
        us = sum(k.duration for k in e.kernels
                 if trace.SPIN_KERNEL not in k.name
                 and k.name not in w.annotations
                 and not k.name.startswith(trace.GEMM_SCOPE))
        if us:
            out.append((e.thread, e.time_range.start, us))
    return out


def window_device_us(w) -> float:
    return sum(k.end - k.start for k in w.kernels)


def step_split(run) -> Optional[Dict[str, float]]:
    """Device milliseconds a step of kernels launched in each phase
    (`forward`, `backward`, `optimizer`) and in the rest of `train.step`,
    over the window's `train.step` scopes, and of the phases' parts
    (`PARTS`: `loss` of the forward, `clip` of the optimizer). None where
    the window holds no step, or where the phases and the rest miss the
    window's kernels by over 2 %."""
    w = run.host_window
    if w is None:
        return None
    steps = Ranges.of(scope_events(w, STEP))
    if not len(steps):
        return None
    phases = {k: (Ranges.of(scope_events(w, name)), any_thread)
              for k, (name, any_thread) in PHASES.items()}
    parts = {k: (Ranges.of(scope_events(w, name)), phase)
             for k, (name, phase) in PARTS.items()}
    out = {k: 0.0 for k in PHASES}
    out["rest"] = 0.0
    held = {k: 0.0 for k in PARTS}
    for th, t, us in launches(w):
        if not steps.holds(t, th, True):
            continue
        for k, (rs, any_thread) in phases.items():
            if rs.holds(t, th, any_thread):
                out[k] += us
                for part, (prs, phase) in parts.items():
                    if phase == k and prs.holds(t, th, False):
                        held[part] += us
                break
        else:
            out["rest"] += us
    total = window_device_us(w)
    if not total or abs(sum(out.values()) - total) > 0.02 * total:
        return None
    out.update(held)
    return {k: v / 1e3 / len(steps) for k, v in out.items()}


def phase_ms(run, phase: str) -> Optional[float]:
    split = step_split(run)
    return None if split is None else split[phase]


def host_syncs(run) -> Optional[float]:
    """Host calls a step that wait for the device (`SYNC_CALLS`), inside
    `train.step` on any thread."""
    w = run.host_window
    if w is None:
        return None
    steps = Ranges.of(scope_events(w, STEP))
    if not len(steps):
        return None
    n = sum(1 for e in w.cpu if e.name in SYNC_CALLS
            and steps.holds(e.time_range.start, e.thread, True))
    return n / len(steps)


def _forward_seq_ranges(w) -> Dict[int, List[Tuple[int, int]]]:
    """Per thread, the sequence numbers of the autograd nodes made inside
    each `moe.einsums` scope: from the first forward op's number inside it
    to one less than the number the first forward op after it carries (an
    op records the number its node takes, or the next one to be taken
    where it makes none)."""
    ops: Dict[int, List[Tuple[float, int]]] = {}
    for e in w.cpu:
        if e.sequence_nr >= 0 and not e.fwd_thread \
                and not getattr(e, "is_user_annotation", False):
            ops.setdefault(e.thread, []).append((e.time_range.start,
                                                 e.sequence_nr))
    starts = {}
    for th, v in ops.items():
        v.sort()
        starts[th] = [t for t, _ in v]
    out: Dict[int, List[Tuple[int, int]]] = {}
    for s in scope_events(w, trace.MOE_SCOPE):
        v, at = ops.get(s.thread, []), starts.get(s.thread, [])
        i = bisect.bisect_left(at, s.time_range.start)
        j = bisect.bisect_right(at, s.time_range.end)
        inside = [n for _, n in v[i:j]]
        if not inside:
            continue
        hi = v[j][1] - 1 if j < len(v) else max(inside)
        out.setdefault(s.thread, []).append((min(inside), hi))
    return out


def moe_backward_us(w) -> float:
    """Device microseconds of the kernels launched by the backward of the
    autograd nodes made in `moe.einsums` scopes: each linked by the
    profiler's (forward thread, sequence number) of the node, which the
    engine's `evaluate_function` event carries. A recomputation run inside
    such a node (it holds `dit_gemm.<mode>` or `moe.einsums` scopes) is
    not its backward: only launches after the last of those count."""
    ranges = _forward_seq_ranges(w)
    if not ranges:
        return 0.0
    nodes = [e for e in w.cpu if e.name.startswith(NODE)
             and e.sequence_nr >= 0 and any(
                 lo <= e.sequence_nr <= hi
                 for lo, hi in ranges.get(e.fwd_thread, []))]
    marks = Ranges.of(e for e in w.cpu if e.name == trace.MOE_SCOPE
                      or e.name.startswith(trace.GEMM_SCOPE))
    spans = []
    for n in nodes:
        s, e = n.time_range.start, n.time_range.end
        last = max((m1 for m0, m1 in marks.by_thread.get(n.thread, [])
                    if s <= m0 and m1 <= e), default=s)
        spans.append((last, e, n.thread))
    held = Ranges(spans)
    return sum(dev for th, t, dev in launches(w)
               if held.holds(t, th, False))


def moe_backward_ms(run) -> Optional[float]:
    """Device milliseconds a step of the MoE einsums' backward."""
    w = run.host_window
    if w is None:
        return None
    steps = len(scope_events(w, STEP))
    if not steps or not scope_events(w, trace.MOE_SCOPE):
        return None
    return moe_backward_us(w) / 1e3 / steps


def moe_dropped(run) -> Optional[float]:
    """Percent of the routed (token, choice) pairs that MoE capacity
    dropped, from the program's `moe.pairs` and `moe.dropped` counters on
    its installed tracer. The program counts only while a profiler runs,
    so the share is over every step the run traced: both sub-windows
    (device only, then with host activity), the same steps' kind each.
    `runner.execute` reads the per-layer metrics before the traffic's
    `release` uninstalls the tracer; read later, this returns None."""
    from repro_torch.obs import get_tracer
    tracer = get_tracer()
    if tracer is None:
        return None
    counters = tracer.metrics.to_dict()["counters"]
    if not counters.get("moe.pairs") or "moe.dropped" not in counters:
        return None
    return 100.0 * counters["moe.dropped"] / counters["moe.pairs"]


def cast_share(run) -> Optional[float]:
    """Percent of the window's kernel time launched in `gemm.cast`."""
    w = run.host_window
    if w is None:
        return None
    casts = Ranges.of(scope_events(w, CAST))
    total = window_device_us(w)
    if not len(casts) or not total:
        return None
    us = sum(dev for th, t, dev in launches(w) if casts.holds(t, th, False))
    return 100.0 * us / total


def resolve_host_us(run) -> Optional[float]:
    """Median host microseconds of a `gemm.resolve` scope."""
    w = run.host_window
    if w is None:
        return None
    durs = [e.time_range.end - e.time_range.start
            for e in scope_events(w, RESOLVE)]
    return statistics.median(durs) if durs else None


def mmad_host_us(run) -> Optional[float]:
    """Median host microseconds of an `mmad.launch` scope less the launch
    calls (`LAUNCH_PREFIXES`) inside it on its thread."""
    w = run.host_window
    if w is None:
        return None
    scopes = scope_events(w, MMAD)
    if not scopes:
        return None
    calls: Dict[int, List[Tuple[float, float]]] = {}
    for e in w.cpu:
        if e.name.startswith(LAUNCH_PREFIXES):
            calls.setdefault(e.thread, []).append((e.time_range.start,
                                                   e.time_range.end))
    for v in calls.values():
        v.sort()
    out = []
    for s in scopes:
        s0, s1 = s.time_range.start, s.time_range.end
        v = calls.get(s.thread, [])
        i = bisect.bisect_left(v, (s0, float("-inf")))
        launch = 0.0
        for c0, c1 in v[i:]:
            if c0 > s1:
                break
            if c1 <= s1:
                launch += c1 - c0
        out.append(s1 - s0 - launch)
    return statistics.median(out)
