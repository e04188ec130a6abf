"""Host mesh construction and device resolution.

The reference builds a `jax.make_mesh` over the host's devices. The port
has two meshes, both exposing what the lowering and the mode bodies read
(`.shape[axis]`, `.axis_names`, the `.device` the tensors live on):

- `HostMesh`, the 1x1 mesh of one device: every collective over it is the
  identity and nothing is launched for it (one H100);
- `DistMesh`, a mesh over an initialised `torch.distributed` world: this
  rank's coordinates, and a process group for each axis, for each sub-axis
  of every `MeshView` the lowering can name and, on a mesh with a `pod`
  axis, for each pod, all created when the mesh is made (the modes reduce
  over one axis at a time; the pod's group, the world's default group on a
  mesh without a `pod` axis, gathers the global result).

`make_host_mesh` returns a `DistMesh` when a process group of more than
one rank is initialised, else a `HostMesh`. NCCL puts one rank on each
card, so on one H100 it is always the 1x1 mesh; the multi-rank meshes run
in the CPU tests as gloo processes (`tests/test_torch_dist.py`).
`make_production_mesh` is the reference's 16x16 (or 2x16x16, with a pure
data-parallel `pod` axis) mesh over a world of exactly that many ranks:
the dry run's fake world (`launch/dryrun.py`), in which this process is
rank 0 and the collectives move no data.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Dict, Mapping, Optional, Sequence, Tuple

import torch


@dataclasses.dataclass(frozen=True)
class HostMesh:
    device: torch.device
    axis_names: Tuple[str, ...] = ("data", "model")
    shape: Mapping[str, int] = dataclasses.field(
        default_factory=lambda: {"data": 1, "model": 1})

    @property
    def size(self) -> int:
        return math.prod(self.shape.values())


def _strides(axis_names: Sequence[str],
             shape: Mapping[str, int]) -> Dict[str, int]:
    """Rank strides of a row-major mesh: the last axis is minor."""
    out, step = {}, 1
    for ax in reversed(axis_names):
        out[ax] = step
        step *= shape[ax]
    return out


@dataclasses.dataclass(frozen=True, eq=False)
class DistMesh:
    """A device mesh over an initialised `torch.distributed` world.

    Ranks fill the mesh row-major, as `jax.make_mesh` fills its device
    grid: rank = sum of coordinate x stride, the last axis minor. `groups`
    maps a tuple of global ranks (ascending, which is axis order) to its
    process group; it holds every group this rank belongs to, created on
    every rank in one order by `make_dist_mesh`. A view (`view`) shares
    them: no group is ever created lazily."""
    device: torch.device
    axis_names: Tuple[str, ...]
    shape: Mapping[str, int]
    rank: int
    strides: Mapping[str, int]
    groups: Mapping[Tuple[int, ...], Any]

    @property
    def size(self) -> int:
        return math.prod(self.shape.values())

    def coord(self, axis: str, rank: Optional[int] = None) -> int:
        """The coordinate of `rank` (this one by default) on `axis`."""
        r = self.rank if rank is None else rank
        return r // self.strides[axis] % self.shape[axis]

    def axis_ranks(self, axis: str, rank: Optional[int] = None
                   ) -> Tuple[int, ...]:
        """The global ranks that share every coordinate of `rank` (this one
        by default) but the one on `axis`, in axis order."""
        r = self.rank if rank is None else rank
        base = r - self.coord(axis, r) * self.strides[axis]
        return tuple(base + c * self.strides[axis]
                     for c in range(self.shape[axis]))

    def group(self, axis: str):
        """The process group along `axis` through this rank."""
        ranks = self.axis_ranks(axis)
        if ranks not in self.groups:
            raise KeyError(f"no process group for axis {axis} (ranks "
                           f"{ranks}); groups are made by make_dist_mesh")
        return self.groups[ranks]

    def pod_ranks(self, rank: Optional[int] = None) -> Tuple[int, ...]:
        """The global ranks that share the `pod` coordinate of `rank` (this
        one by default), ascending: the whole world on a mesh without a
        `pod` axis."""
        r = self.rank if rank is None else rank
        if "pod" not in self.shape:
            return tuple(range(self.size))
        stride, c = self.strides["pod"], self.coord("pod", r)
        if stride * self.shape["pod"] == self.size:     # a leading axis
            return tuple(range(c * stride, (c + 1) * stride))
        return tuple(q for q in range(self.size)
                     if self.coord("pod", q) == c)

    def pod_group(self):
        """The process group of this rank's pod (of more than one rank):
        the world's default group (None) on a mesh without a `pod`
        axis."""
        if "pod" not in self.shape:
            return None
        return self.groups[self.pod_ranks()]

    def view(self, splits) -> "DistMesh":
        """The mesh with physical axes split into sub-axes (a `MeshView`'s
        `splits`: outer-major, so the device order is kept), sharing this
        mesh's process groups."""
        split_map = dict(splits)
        names, shape, strides = [], {}, {}
        for ax in self.axis_names:
            subs = split_map.get(ax, ((ax, self.shape[ax]),))
            if math.prod(size for _, size in subs) != self.shape[ax]:
                raise ValueError(f"view {subs} does not split axis {ax} of "
                                 f"size {self.shape[ax]}")
            step = self.strides[ax]
            for name, size in reversed(subs):
                strides[name] = step
                step *= size
            for name, size in subs:
                names.append(name)
                shape[name] = size
        return DistMesh(self.device, tuple(names), shape, self.rank, strides,
                        self.groups)


def resolve_device(device="cuda") -> torch.device:
    """The device an entry point runs on: the card unless the caller asked
    for the CPU. With no card and no CPU request this raises — nothing
    falls back to the CPU."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device is available; pass device='cpu' "
                           "(--device cpu) to run on the CPU")
    return dev


def make_dist_mesh(shape: Tuple[int, ...], device,
                   axis_names: Tuple[str, ...] = ("data", "model")
                   ) -> DistMesh:
    """A `DistMesh` of `shape` over the initialised world. Collective:
    every rank calls it with the same arguments, and it creates, in one
    order, the process group of every axis and of every sub-axis of the
    views `core.lower.mesh_views` lists for the last two axes (the only
    views a plan can name: the modes run over `data` and `model`; a
    leading `pod` axis is pure data parallelism and gets its own group),
    and with a `pod` axis the group of each pod's ranks (the modes' and
    the sharded parameters' collectives stay within a pod)."""
    import torch.distributed as dist
    from repro_torch.core.lower import mesh_views

    if len(shape) != len(axis_names):
        raise ValueError(f"mesh shape {tuple(shape)} does not match axes "
                         f"{tuple(axis_names)}")
    world = dist.get_world_size()
    sizes = dict(zip(axis_names, shape))
    if math.prod(shape) != world:
        raise ValueError(f"a {tuple(shape)} mesh needs {math.prod(shape)} "
                         f"ranks, the world has {world}")
    mesh = DistMesh(torch.device(device), tuple(axis_names), sizes,
                    dist.get_rank(), _strides(axis_names, sizes), {})
    wanted: Dict[Tuple[int, ...], None] = {}     # ordered set
    for m in [mesh] + [mesh.view(v.splits)
                       for v in mesh_views(sizes, *axis_names[-2:])]:
        for ax in m.axis_names:
            if m.shape[ax] < 2:
                continue
            for r in range(world):
                wanted.setdefault(m.axis_ranks(ax, r))
    if "pod" in sizes and world // sizes["pod"] > 1:
        for r in range(world):
            wanted.setdefault(mesh.pod_ranks(r))
    groups = {}
    for ranks in wanted:                 # the same order on every rank
        group = dist.new_group(list(ranks))
        if mesh.rank in ranks:
            groups[ranks] = group
    return dataclasses.replace(mesh, groups=groups)


def make_production_mesh(*, multi_pod: bool = False,
                         device="meta") -> DistMesh:
    """The reference's production mesh over the initialised world: one
    16x16 ('data', 'model') pod, or with `multi_pod` a 2x16x16 ('pod',
    'data', 'model') one whose leading axis is pure data parallelism. The
    world must hold exactly 256 (or 512) ranks: no smaller mesh is ever
    built in its place. The dry run initialises a fake world of that size
    and traces on the meta device, its default."""
    import torch.distributed as dist

    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    need = math.prod(shape)
    world = (dist.get_world_size()
             if dist.is_available() and dist.is_initialized() else 0)
    if world != need:
        raise ValueError(f"the production mesh {shape} needs a world of "
                         f"{need} ranks; the initialised world has "
                         f"{world or 'none'}")
    return make_dist_mesh(shape, device, axes)


def make_host_mesh(device="cuda"):
    """The host's mesh: over an initialised process group of more than one
    rank, a (world, 1) ('data', 'model') `DistMesh`, as the reference's
    `make_host_mesh` lays out its devices; otherwise the 1x1 mesh of one
    device."""
    dev = resolve_device(device)
    import torch.distributed as dist
    if dist.is_available() and dist.is_initialized() \
            and dist.get_world_size() > 1:
        return make_dist_mesh((dist.get_world_size(), 1), dev)
    return HostMesh(device=dev)
