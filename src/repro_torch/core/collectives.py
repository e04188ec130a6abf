"""Differentiable collectives over a mesh axis — the port's `jax.lax`
`axis_index`, `psum`, `pmax`, `all_gather`, `psum_scatter` and `ppermute`
inside `shard_map`, on `torch.distributed`.

Each takes the mesh and an axis name, and runs over that axis's process
group (`DistMesh.group`). On an axis of size 1 (every axis of the one-card
`HostMesh`) each is the identity and launches nothing. The backward of
each is its transpose: `psum` <-> `psum`, `all_gather` <-> `psum_scatter`,
`ppermute` <-> the inverse permutation; `pmax` is forward only, as the
reference uses it (under a stop-gradient).

`shard` and `unshard` are the port's counterpart of a jax global array
crossing a `shard_map` boundary. Operands arrive whole on every rank of a
pod; `shard` takes this rank's block as a spec says (the reference's
`in_specs`: per dimension None or a tuple of axes, major first), and its
backward sums the blocks' gradients over the pod, so every rank of it ends
with the pod's global gradient. `unshard` gathers the out spec's blocks
over the pod so each of its ranks returns the same global tensor; a block
held by several ranks (an axis the spec leaves out) is taken from the
lowest of them, and only that rank's copy receives the gradient. A pod is
the ranks that share a `pod` coordinate (`DistMesh.pod_ranks`): the whole
world on a mesh without a `pod` axis. With one, each pod runs its own
share of the batch (`parallel.sharded`), so nothing crosses pods here.

Every rank must issue the same collectives in the same order, backward
included: the mode bodies select rank-dependent values with `pick` (both
sides stay in the autograd graph, as `jnp.where` keeps them), never with a
Python branch around a collective's input.

Every call into `torch.distributed` goes through one helper here, which
counts it while a recording is active (`recording`, used by
`launch.hlo_stats.record_collectives`): its kind under the reference's HLO
names (`all-reduce` for `psum`, `pmax` and the backward of `shard`;
`all-gather` for `all_gather` and `unshard`; `reduce-scatter`;
`collective-permute` for `ppermute` and `ppermute_start`) and its operand's
bytes, forward and backward alike. A collective on a size-1 axis is the
identity and is not counted. On the meta device (the dry run's shape-only
trace over a fake world) `ppermute` posts nothing and returns an empty
tensor of its operand's shape, still counted; the other collectives take
the fake process group's meta tensors as they are.
"""
from __future__ import annotations

import contextlib
import math
from typing import Callable, Iterator, List, Optional, Sequence, Tuple

import torch

Spec = Sequence[Optional[Tuple[str, ...]]]


def axis_size(mesh, axis: str) -> int:
    return int(mesh.shape[axis])


def axis_index(mesh, axis: str) -> int:
    """This rank's coordinate on `axis` (0 on a size-1 axis)."""
    return mesh.coord(axis) if axis_size(mesh, axis) > 1 else 0


def pick(cond: bool, x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """`x if cond else y` with both in the autograd graph on every rank,
    so every rank runs the same backward collectives (`jnp.where`)."""
    return torch.where(torch.tensor(cond, device=x.device), x, y)


def _dist():
    import torch.distributed as dist
    return dist


# (kind, operand bytes) -> None while a recording is active
_recorder: Optional[Callable[[str, int], None]] = None


@contextlib.contextmanager
def recording(add: Callable[[str, int], None]) -> Iterator[None]:
    """Call `add(kind, operand_bytes)` for every collective called inside
    the block (nested recordings: the innermost one counts)."""
    global _recorder
    prev, _recorder = _recorder, add
    try:
        yield
    finally:
        _recorder = prev


def _count(kind: str, x: torch.Tensor) -> None:
    if _recorder is not None:
        _recorder(kind, x.numel() * x.element_size())


def _all_reduce(x: torch.Tensor, group=None, op=None) -> None:
    """In-place all-reduce of `x` (a sum unless `op` says otherwise)."""
    _count("all-reduce", x)
    dist = _dist()
    dist.all_reduce(x, op=dist.ReduceOp.SUM if op is None else op,
                    group=group)


def _all_gather(parts: List[torch.Tensor], x: torch.Tensor,
                group=None) -> None:
    _count("all-gather", x)
    _dist().all_gather(parts, x, group=group)


class _Psum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        y = x.contiguous().clone()
        _all_reduce(y, group)
        return y

    @staticmethod
    def backward(ctx, g):
        g = g.contiguous().clone()
        _all_reduce(g, ctx.group)
        return g, None


def psum(x: torch.Tensor, mesh, axis: str) -> torch.Tensor:
    """Sum over `axis`; every rank of the axis gets the sum."""
    if axis_size(mesh, axis) == 1:
        return x
    return _Psum.apply(x, mesh.group(axis))


def pmax(x: torch.Tensor, mesh, axis: str) -> torch.Tensor:
    """Max over `axis`, forward only (the input is detached)."""
    if axis_size(mesh, axis) == 1:
        return x.detach()
    y = x.detach().contiguous().clone()
    _all_reduce(y, mesh.group(axis), _dist().ReduceOp.MAX)
    return y


def _gather(x: torch.Tensor, group, n: int, dim: int) -> torch.Tensor:
    x = x.contiguous()
    parts = [torch.empty_like(x) for _ in range(n)]
    _all_gather(parts, x, group)
    return torch.cat(parts, dim=dim)


def _scatter(x: torch.Tensor, group, n: int, dim: int) -> torch.Tensor:
    chunks = [c.contiguous() for c in x.chunk(n, dim=dim)]
    out = torch.empty_like(chunks[0])
    _count("reduce-scatter", x)
    _dist().reduce_scatter(out, chunks, group=group)
    return out


class _AllGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, n, dim):
        ctx.args = (group, n, dim)
        return _gather(x, group, n, dim)

    @staticmethod
    def backward(ctx, g):
        return _scatter(g, *ctx.args), None, None, None


class _PsumScatter(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, n, dim):
        ctx.args = (group, n, dim)
        return _scatter(x, group, n, dim)

    @staticmethod
    def backward(ctx, g):
        return _gather(g, *ctx.args), None, None, None


def all_gather(x: torch.Tensor, mesh, axis: str, dim: int) -> torch.Tensor:
    """Concatenate the axis's blocks along `dim`, in axis order (tiled)."""
    n = axis_size(mesh, axis)
    if n == 1:
        return x
    return _AllGather.apply(x, mesh.group(axis), n, dim)


def psum_scatter(x: torch.Tensor, mesh, axis: str, dim: int) -> torch.Tensor:
    """Sum over `axis`; rank i keeps block i of `dim` (tiled)."""
    n = axis_size(mesh, axis)
    if n == 1:
        return x
    if x.shape[dim] % n:
        raise ValueError(f"psum_scatter: dim {dim} of {tuple(x.shape)} does "
                         f"not divide by {n}")
    return _PsumScatter.apply(x, mesh.group(axis), n, dim)


class _Pending:
    """The receive of a ppermute whose sends and receives are posted:
    `wait()` completes them and returns the received tensor."""

    def __init__(self):
        self.works: List = []
        self.out: Optional[torch.Tensor] = None

    def wait(self) -> torch.Tensor:
        for w in self.works:
            w.wait()
        self.works = []
        return self.out


def _post(x: torch.Tensor, group, ranks: Tuple[int, ...], me: int,
          pairs) -> Tuple[torch.Tensor, List]:
    """Post this rank's sends and receives of a permutation of axis
    indices: returns the buffer the receive fills (zeros when nothing
    arrives) and the works to wait on. A meta tensor has no data to send:
    it posts nothing and returns an empty tensor of its shape."""
    _count("collective-permute", x)
    if x.device.type == "meta":
        return torch.empty_like(x), []
    dist = _dist()
    x = x.contiguous()
    ops = [dist.P2POp(dist.isend, x, ranks[dst], group)
           for src, dst in pairs if src == me]
    srcs = [src for src, dst in pairs if dst == me]
    out = torch.empty_like(x) if srcs else torch.zeros_like(x)
    ops += [dist.P2POp(dist.irecv, out, ranks[src], group) for src in srcs]
    return out, (dist.batch_isend_irecv(ops) if ops else [])


class _PPermute(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, ranks, me, pairs, pending):
        ctx.args = (group, ranks, me, tuple((d, s) for s, d in pairs))
        out, works = _post(x, group, ranks, me, pairs)
        if pending is None:
            for w in works:
                w.wait()
        else:
            pending.works = works
        return out

    @staticmethod
    def backward(ctx, g):
        group, ranks, me, inverse = ctx.args
        out, works = _post(g, group, ranks, me, inverse)
        for w in works:
            w.wait()
        return out, None, None, None, None, None


def _ppermute(x, mesh, axis, perm, pending):
    pairs = tuple((int(s), int(d)) for s, d in perm)
    return _PPermute.apply(x, mesh.group(axis), mesh.axis_ranks(axis),
                           mesh.coord(axis), pairs, pending)


def ppermute(x: torch.Tensor, mesh, axis: str, perm) -> torch.Tensor:
    """Send this rank's `x` along the (source, destination) axis-index
    pairs of `perm`; a rank nothing is sent to gets zeros."""
    if axis_size(mesh, axis) == 1:
        return x
    return _ppermute(x, mesh, axis, perm, None)


def ppermute_start(x: torch.Tensor, mesh, axis: str, perm) -> _Pending:
    """`ppermute` with its sends and receives posted and not waited on:
    the caller computes, then calls `wait()` on the result. Its backward
    is synchronous."""
    pending = _Pending()
    if axis_size(mesh, axis) == 1:
        pending.out = x
    else:
        # the buffer the posted receive fills, as autograd's output
        pending.out = _ppermute(x, mesh, axis, perm, pending)
    return pending


# ---------------------------------------------------------------------------
# global tensors across the shard_map boundary
# ---------------------------------------------------------------------------

def _block(mesh, spec: Spec, shape, rank: int) -> Tuple[slice, ...]:
    """The slices of `rank`'s block of a tensor of `shape` under `spec`."""
    out = []
    for size, axes in zip(shape, spec):
        if not axes:
            out.append(slice(None))
            continue
        n = math.prod(axis_size(mesh, ax) for ax in axes)
        if size % n:
            raise ValueError(f"dimension of size {size} does not divide by "
                             f"{n} ranks of {axes}")
        idx = 0
        for ax in axes:
            idx = idx * axis_size(mesh, ax) + mesh.coord(ax, rank)
        w = size // n
        out.append(slice(idx * w, (idx + 1) * w))
    return tuple(out)


def _owner(mesh, spec: Spec, shape, rank: int, ranks=None) -> bool:
    """Whether `rank` is the lowest of `ranks` (its pod's by default)
    holding its block."""
    mine = _block(mesh, spec, shape, rank)
    ranks = mesh.pod_ranks(rank) if ranks is None else ranks
    return all(_block(mesh, spec, shape, r) != mine for r in ranks
               if r < rank)


def _pod_size(mesh) -> int:
    return mesh.size // int(mesh.shape.get("pod", 1))


class _Shard(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh, spec):
        ctx.sl = _block(mesh, spec, x.shape, mesh.rank)
        ctx.shape = x.shape
        ctx.group = mesh.pod_group()
        return x[ctx.sl].clone()

    @staticmethod
    def backward(ctx, g):
        full = g.new_zeros(ctx.shape)
        full[ctx.sl] = g
        _all_reduce(full, ctx.group)
        return full, None, None


class _Unshard(torch.autograd.Function):
    @staticmethod
    def forward(ctx, y, mesh, spec, shape):
        ranks = mesh.pod_ranks()
        parts = [torch.empty_like(y) for _ in ranks]
        _all_gather(parts, y.contiguous(), mesh.pod_group())
        out = y.new_empty(shape)
        done = set()
        for r, part in zip(ranks, parts):
            sl = _block(mesh, spec, shape, r)
            key = tuple((s.start, s.stop) for s in sl)
            if key not in done:
                out[sl] = part
                done.add(key)
        ctx.sl = _block(mesh, spec, shape, mesh.rank)
        ctx.owner = _owner(mesh, spec, shape, mesh.rank, ranks)
        return out

    @staticmethod
    def backward(ctx, g):
        grad = g[ctx.sl]
        return (grad.clone() if ctx.owner else torch.zeros_like(grad),
                None, None, None)


def _spec(spec) -> Tuple[Optional[Tuple[str, ...]], ...]:
    return tuple((ax,) if isinstance(ax, str) else
                 (tuple(ax) if ax else None) for ax in spec)


def shard(x: torch.Tensor, mesh, spec) -> torch.Tensor:
    """This rank's block of the pod's global `x` (whole on every rank of
    the pod)."""
    if _pod_size(mesh) == 1:
        return x
    return _Shard.apply(x, mesh, _spec(spec))


def unshard(y: torch.Tensor, mesh, spec, shape) -> torch.Tensor:
    """The pod's global tensor of `shape` whose blocks its ranks hold as
    `y`."""
    if _pod_size(mesh) == 1:
        return y
    return _Unshard.apply(y, mesh, _spec(spec), tuple(shape))
