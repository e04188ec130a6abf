"""Counted collectives (`launch/hlo_stats.record_collectives`) on a fake
`torch.distributed` world, against hand counts and the reference's
`CollectiveStats.summary()`.

The module initialises a fake 16-rank world in this process (the
`torch.distributed` "fake" backend moves no data) and destroys it after.
Every collective of `core/collectives.py` is counted once per call, under
the reference's HLO name, with its operand's bytes, on CPU tensors and on
meta tensors alike; on the meta device `ppermute` posts no send or
receive.
"""
import pytest
import torch
import torch.distributed as dist

from repro.launch.hlo_stats import CollectiveStats as RefCollectiveStats
from repro_torch.core import collectives as C
from repro_torch.launch.hlo_stats import CollectiveStats, record_collectives
from repro_torch.launch.mesh import HostMesh, make_dist_mesh


@pytest.fixture(scope="module")
def mesh():
    from torch.testing._internal.distributed.fake_pg import FakeStore
    assert not dist.is_initialized()
    dist.init_process_group("fake", rank=0, world_size=16, store=FakeStore())
    try:
        yield make_dist_mesh((4, 4), "cpu")
    finally:
        dist.destroy_process_group()


def _nbytes(t):
    return t.numel() * t.element_size()


@pytest.mark.parametrize("device", ["cpu", "meta"])
def test_forward_kinds_and_bytes(mesh, device):
    x = torch.empty(8, 12, dtype=torch.bfloat16, device=device)
    y = torch.empty(8, 12, dtype=torch.float32, device=device)
    with record_collectives() as st:
        C.psum(x, mesh, "data")
        C.pmax(y, mesh, "model")
        g = C.all_gather(x, mesh, "model", 1)
        s = C.psum_scatter(y, mesh, "data", 0)
        p = C.ppermute(x, mesh, "model", [(0, 1), (1, 2), (2, 3), (3, 0)])
        q = C.ppermute_start(y, mesh, "data", [(0, 1)]).wait()
    assert g.shape == (8, 48) and s.shape == (2, 12)
    assert p.shape == x.shape and q.shape == y.shape
    assert p.device.type == device
    b16, b32 = _nbytes(x), _nbytes(y)
    assert st.count_by_kind == {"all-reduce": 2, "all-gather": 1,
                                "reduce-scatter": 1, "collective-permute": 2,
                                "all-to-all": 0}
    assert st.bytes_by_kind == {"all-reduce": b16 + b32, "all-gather": b16,
                                "reduce-scatter": b32,
                                "collective-permute": b16 + b32,
                                "all-to-all": 0}
    assert st.total_bytes == 3 * b16 + 3 * b32


@pytest.mark.parametrize("device", ["cpu", "meta"])
def test_backward_collectives_are_counted(mesh, device):
    """Each transpose counts as its own kind: psum <-> psum, all_gather
    <-> psum_scatter, ppermute <-> the inverse permutation."""
    x = torch.empty(4, 8, device=device, requires_grad=True)
    with record_collectives() as st:
        out = (C.psum(x, mesh, "data").sum()
               + C.all_gather(x, mesh, "model", 0).sum()
               + C.ppermute(x, mesh, "model", [(0, 1)]).sum())
        fwd = dict(st.count_by_kind)
        out.backward()
    b = _nbytes(x)
    assert fwd == {"all-reduce": 1, "all-gather": 1, "reduce-scatter": 0,
                   "collective-permute": 1, "all-to-all": 0}
    assert st.count_by_kind == {"all-reduce": 2, "all-gather": 1,
                                "reduce-scatter": 1, "collective-permute": 2,
                                "all-to-all": 0}
    # the all_gather's cotangent is the gathered (16, 8) tensor
    assert st.bytes_by_kind["reduce-scatter"] == 4 * b
    assert st.bytes_by_kind["all-reduce"] == 2 * b


def test_meta_ppermute_posts_nothing(mesh, monkeypatch):
    def refuse(*a, **k):
        raise AssertionError("a meta ppermute must not post a send")
    monkeypatch.setattr(dist, "batch_isend_irecv", refuse)
    x = torch.empty(3, 5, device="meta")
    with record_collectives() as st:
        out = C.ppermute(x, mesh, "data", [(0, 1), (1, 0)])
        C.ppermute_start(x, mesh, "model", [(1, 2)]).wait()
    assert out.shape == x.shape and out.device.type == "meta"
    assert st.count_by_kind["collective-permute"] == 2
    with pytest.raises(AssertionError):
        C.ppermute(torch.zeros(3, 5), mesh, "data", [(0, 1)])


def test_size_one_axis_and_no_recording_count_nothing(mesh):
    x = torch.ones(2, 2)
    host = HostMesh(torch.device("cpu"))
    with record_collectives() as st:
        assert C.psum(x, host, "data") is x
        assert C.all_gather(x, host, "model", 0) is x
        assert C.ppermute(x, host, "data", [(0, 0)]) is x
    assert st.total_bytes == 0 and not any(st.count_by_kind.values())
    # outside a recording nothing is counted, and recordings nest
    C.psum(x, mesh, "data")
    with record_collectives() as outer:
        C.psum(x, mesh, "data")
        with record_collectives() as inner:
            C.psum(x, mesh, "model")
    assert outer.count_by_kind["all-reduce"] == 1
    assert inner.count_by_kind["all-reduce"] == 1


def test_summary_matches_reference(mesh):
    with record_collectives() as st:
        C.psum(torch.empty(1024, 512, device="meta"), mesh, "data")
        C.all_gather(torch.empty(256, 256, dtype=torch.bfloat16,
                                 device="meta"), mesh, "model", 0)
        C.ppermute(torch.empty(333, device="meta"), mesh, "model", [(0, 1)])
    ref = RefCollectiveStats(dict(st.bytes_by_kind), dict(st.count_by_kind))
    assert st.summary() == ref.summary()
    assert st.total_bytes == ref.total_bytes
    assert st.summary() == ("all-gather:0.1MB(x1) all-reduce:2.1MB(x1) "
                            "collective-permute:0.0MB(x1)")
    empty = CollectiveStats({}, {})
    assert empty.summary() == RefCollectiveStats({}, {}).summary() == "none"
