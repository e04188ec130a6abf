"""The readers of the program's scopes (`bench/metrics/_scopes.py`) on
hand-built host windows: fake host events and kernels, no profiler."""
from types import SimpleNamespace as NS

import pytest

from bench.harness import core
from bench.metrics import _scopes

MAIN, ENGINE = 1, 2                      # the host's thread, autograd's
NODE = _scopes.NODE


def ev(name, start, end, thread=MAIN, kernels=(), seq=-1, fwd=0,
       annotation=False):
    """A host event; `kernels` the device microseconds tied to it."""
    return NS(name=name, time_range=NS(start=start, end=end), thread=thread,
              kernels=[NS(name=f"k{i}", duration=us)
                       for i, us in enumerate(kernels)],
              sequence_nr=seq, fwd_thread=fwd, is_user_annotation=annotation)


def scope(name, start, end, thread=MAIN, kernels=()):
    return ev(name, start, end, thread, kernels, annotation=True)


def window(events, extra_kernel_us=0.0):
    """The window's kernels are those tied to its events (one kernel each,
    laid end to end), plus `extra_kernel_us` tied to none."""
    kernels, t = [], 0.0
    for e in events:
        if e.name.startswith("cu"):
            continue
        for k in e.kernels:
            kernels.append(NS(name=k.name, start=t, end=t + k.duration))
            t += k.duration
    if extra_kernel_us:
        kernels.append(NS(name="lost", start=t, end=t + extra_kernel_us))
    return NS(cpu=list(events), kernels=kernels, annotations=set())


def run_of(w):
    return NS(host_window=w, traced_units=2)


def step_events(t0):
    """One step from t0: forward 10 us (the loss 2 us of it), backward on
    the engine's thread 20 us, the optimizer 30 us (the clip 5 us of it),
    the rest 4 us; a runtime call's copy of a kernel, not counted."""
    return [
        scope("train.step", t0, t0 + 100),
        scope("train.forward", t0 + 1, t0 + 20),
        ev("aten::mm", t0 + 2, t0 + 3, kernels=[8.0]),
        scope("train.loss", t0 + 4, t0 + 6),
        ev("aten::add", t0 + 5, t0 + 6, kernels=[2.0]),
        ev("cudaLaunchKernel", t0 + 5, t0 + 5.5, kernels=[2.0]),
        scope("train.backward", t0 + 21, t0 + 60),
        ev("aten::mm", t0 + 30, t0 + 31, ENGINE, kernels=[20.0]),
        scope("optim.adamw", t0 + 61, t0 + 90),
        scope("optim.clip", t0 + 62, t0 + 70),
        ev("aten::mul", t0 + 63, t0 + 64, kernels=[5.0]),
        ev("aten::add_", t0 + 75, t0 + 76, kernels=[25.0]),
        ev("cudaStreamSynchronize", t0 + 80, t0 + 81),
        ev("aten::copy_", t0 + 95, t0 + 96, kernels=[4.0]),
    ]


TWO_STEPS = step_events(0.0) + step_events(1000.0)


def test_step_split_attributes_by_launch_and_divides_by_steps():
    split = _scopes.step_split(run_of(window(TWO_STEPS)))
    assert split == pytest.approx({"forward": 0.010, "backward": 0.020,
                                   "optimizer": 0.030, "rest": 0.004,
                                   "loss": 0.002, "clip": 0.005})
    for phase in ("forward", "backward", "optimizer", "loss", "clip"):
        name = f"{phase}_ms.train"
        assert core.load_module("metrics", name).read(
            run_of(window(TWO_STEPS))) == pytest.approx(split[phase])


def test_backward_takes_the_engine_thread_forward_its_own():
    events = step_events(0.0) + [
        ev("aten::mul", 10, 11, ENGINE, kernels=[3.0])]   # another thread
    split = _scopes.step_split(run_of(window(events)))
    assert split["forward"] == pytest.approx(0.010)
    assert split["rest"] == pytest.approx(0.004 + 0.003)


def test_a_part_counts_only_its_own_phase_and_thread():
    events = step_events(0.0) + [
        scope("optim.clip", 30, 32, ENGINE),    # inside the backward
        scope("train.loss", 96, 97),            # outside the forward
        ev("aten::add", 96.5, 96.7, kernels=[1.0])]
    split = _scopes.step_split(run_of(window(events)))
    assert split["loss"] == pytest.approx(0.002)
    assert split["clip"] == pytest.approx(0.005)
    assert split["backward"] == pytest.approx(0.020)
    assert split["rest"] == pytest.approx(0.005)
    assert split["forward"] + split["backward"] + split["optimizer"] \
        + split["rest"] == pytest.approx(0.065)


@pytest.mark.parametrize("lost_us,reads", [(0.5, True), (10.0, False)])
def test_phases_must_cover_the_window_within_2_percent(lost_us, reads):
    # the two steps' kernels come to 128 us: 0.5 us lost is 0.4 %, 10 us 7.8 %
    split = _scopes.step_split(run_of(window(TWO_STEPS, lost_us)))
    assert (split is not None) == reads


def test_host_syncs_inside_the_step_on_any_thread():
    events = step_events(0.0) + [
        ev("cudaDeviceSynchronize", 50, 51, ENGINE),
        ev("cudaMemcpy", 52, 53),
        ev("cudaMemcpyAsync", 54, 55),                    # not a wait
        ev("cudaStreamSynchronize", 500, 501)]            # outside a step
    w = window(events)
    assert _scopes.host_syncs(run_of(w)) == 3.0
    assert core.load_module("metrics", "host_syncs.train").read(
        run_of(window(TWO_STEPS))) == 1.0


def moe_events():
    """A step whose forward runs a `moe.einsums` scope making nodes 5 and 6
    (a bmm and a mul); op 7 after it makes node 7. The engine runs node 7
    (not the einsums'), node 6 whose evaluation first recomputes a layer
    (a `dit_gemm.summa` scope inside it), and node 5."""
    return [
        scope("train.step", 0, 400),
        scope("train.forward", 1, 100),
        ev("aten::mm", 2, 3, kernels=[1.0], seq=4),
        scope("moe.einsums", 10, 40),
        ev("aten::einsum", 11, 20, seq=5),
        ev("aten::bmm", 12, 19, kernels=[6.0], seq=5),
        ev("aten::mul", 21, 22, kernels=[1.0], seq=6),
        ev("aten::one_hot", 30, 31, seq=7),           # makes no node
        ev("aten::mm", 50, 51, kernels=[2.0], seq=7),
        scope("train.backward", 101, 300),
        ev(NODE + "MmBackward0", 110, 120, ENGINE, seq=7, fwd=MAIN),
        ev("aten::mm", 111, 112, ENGINE, kernels=[4.0]),
        ev(NODE + "MulBackward0", 130, 170, ENGINE, seq=6, fwd=MAIN),
        scope("dit_gemm.summa", 131, 150, ENGINE),
        ev("aten::mm", 132, 133, ENGINE, kernels=[9.0]),   # recompute
        ev("aten::mul", 160, 161, ENGINE, kernels=[3.0]),
        ev(NODE + "BmmBackward0", 180, 200, ENGINE, seq=5, fwd=MAIN),
        ev("aten::bmm", 181, 182, ENGINE, kernels=[7.0]),
        # a node of the engine's own thread with the same number: another
        # op's, not the einsums'
        ev(NODE + "BmmBackward0", 210, 220, ENGINE, seq=5, fwd=ENGINE),
        ev("aten::bmm", 211, 212, ENGINE, kernels=[50.0]),
    ]


def test_moe_backward_follows_sequence_numbers():
    w = window(moe_events())
    assert _scopes._forward_seq_ranges(w) == {MAIN: [(5, 6)]}
    assert _scopes.moe_backward_us(w) == pytest.approx(3.0 + 7.0)
    assert core.load_module("metrics", "moe_einsum_bwd_ms.train").read(
        run_of(w)) == pytest.approx(0.010)


def gemm_events(t0, mmad_us, launch_us, resolve_us):
    """One routed call: resolution, the mode body with `mmad.launch` (a
    launch call inside it) and the cast of C."""
    return [
        scope("gemm.resolve", t0, t0 + resolve_us),
        scope("dit_gemm.summa", t0 + 20, t0 + 200),
        # the kernel is tied to the scope: the launch is no torch op
        scope("mmad.launch", t0 + 30, t0 + 30 + mmad_us, kernels=[80.0]),
        ev("cudaLaunchKernel", t0 + 40, t0 + 40 + launch_us),
        scope("gemm.cast", t0 + 150, t0 + 170),
        ev("aten::to", t0 + 151, t0 + 160, kernels=[20.0]),
    ]


def test_gemm_readers():
    events = (gemm_events(0, 50, 30, 10) + gemm_events(1000, 60, 10, 12)
              + gemm_events(2000, 90, 0, 40))
    run = run_of(window(events))
    assert _scopes.cast_share(run) == pytest.approx(20.0)
    assert _scopes.resolve_host_us(run) == 12
    # 50 - 30, 60 - 10, 90 - 0
    assert _scopes.mmad_host_us(run) == 50
    for name, want in (("cast_share.gemm", 20.0),
                       ("resolve_host_us.gemm", 12),
                       ("mmad_host_us.gemm", 50)):
        assert core.load_module("metrics", name).read(run) == \
            pytest.approx(want)


def test_a_launch_call_on_another_thread_is_not_subtracted():
    events = gemm_events(0, 50, 0, 10) + [
        ev("cudaLaunchKernel", 35, 70, ENGINE)]
    assert _scopes.mmad_host_us(run_of(window(events))) == 50


NEW = ("forward_ms.train", "backward_ms.train", "optimizer_ms.train",
       "loss_ms.train", "clip_ms.train", "host_syncs.train", "moe_einsum_bwd_ms.train", "cast_share.gemm",
       "resolve_host_us.gemm", "mmad_host_us.gemm")


@pytest.mark.parametrize("name", NEW)
def test_a_program_without_the_scopes_reads_nothing(name):
    events = [ev("aten::mm", 0, 1, kernels=[5.0]),
              scope("dit_gemm.summa", 2, 9),
              ev("mmad_kernel_launch", 3, 4, kernels=[9.0])]
    read = core.load_module("metrics", name).read
    assert read(run_of(window(events))) is None
    assert read(NS(host_window=None, traced_units=0)) is None


def test_moe_dropped_reads_the_tracers_counters():
    torch = pytest.importorskip("torch")
    from repro_torch.obs import Tracer, tracing
    read = core.load_module("metrics", "moe_dropped.train").read
    tracer = Tracer(process_name="bench")
    with tracing(tracer):
        assert read(run_of(None)) is None          # nothing counted
        tracer.metrics.counter("moe.pairs").inc(400)
        tracer.metrics.counter("moe.dropped").inc(torch.tensor(3))
        tracer.metrics.counter("moe.dropped").inc(torch.tensor(2))
        assert read(run_of(None)) == pytest.approx(1.25)
    assert read(run_of(None)) is None              # no tracer
