"""Parameters kept sharded by `spec_rules` and gathered on use — the port's
counterpart of the reference's `jax.device_put(params, param_shardings(...))`
on the production mesh.

The reference gets this layout from GSPMD; the port writes it out:

- **State layout.** Each rank holds, of each parameter, the block
  `spec_rules.param_spec` gives it on the mesh's `data` and `model` axes
  (`Placement.block`), and the same block of the parameter's AdamW moments
  and compression residual (they are made like the blocks). The `pod` axis
  never appears in a weight spec, so each pod holds a whole copy of the
  state, and a rank's state bytes are the sum of `spec_rules.local_bytes`.
- **Gather on use.** `shard_params` swaps each module that holds a
  parameter to a subclass whose attribute read all-gathers the parameter
  whole over its spec's axes, within the pod (`gather`). The parameters'
  names, order and `state_dict` stay the model's own. The gather's backward
  takes this rank's block of the whole gradient: it slices and never sums,
  because every rank of the pod already holds the same whole gradient (the
  routed modes' `shard` backward sums over the pod; unrouted, every rank of
  the pod computes it on the same whole activations). Under remat the
  recomputation gathers again, so no whole weight outlives its layer.
- **Data parallelism over pods.** Activations are whole within a pod; the
  batch splits over the `pod` axis only (`pod_batch`), and the gradients
  and the loss are averaged over it (`mean_over_pods`).
- **Counting each block once.** A block replicated over ranks (any axis
  its spec leaves out, `pod` included) counts on the lowest rank holding
  it (`Placement.owner`), as the global norm needs.

On a mesh of one rank every gather is the identity and hands back the
parameter itself, so the step is the unsharded step, operation for
operation.
"""
from __future__ import annotations

import dataclasses
import functools
from typing import Any, Dict, Mapping, Optional, Tuple

import torch
from torch import nn

from repro_torch.core import collectives
from repro_torch.parallel import spec_rules


@dataclasses.dataclass(frozen=True, eq=False)
class Placement:
    """Where the blocks of one tensor of `shape` live: `spec` (one entry
    per dimension, as `spec_rules` writes them) on `mesh` (a `DistMesh`)."""
    mesh: Any
    spec: spec_rules.Spec
    shape: Tuple[int, ...]

    @functools.cached_property
    def _spec(self):
        return collectives._spec(tuple(self.spec)
                                 + (None,) * (len(self.shape)
                                              - len(self.spec)))

    def block(self, rank: Optional[int] = None) -> Tuple[slice, ...]:
        """The slices of `rank`'s block (this rank's by default)."""
        return collectives._block(self.mesh, self._spec, self.shape,
                                  self.mesh.rank if rank is None else rank)

    @functools.cached_property
    def gather_ranks(self) -> Tuple[int, ...]:
        """The ranks whose blocks make up the whole tensor with this one's:
        those that differ from it on the spec's axes only (within its
        pod, since no spec names `pod`), ascending."""
        axes = {ax for entry in self._spec if entry for ax in entry}
        fixed = [ax for ax in self.mesh.axis_names if ax not in axes]
        mine = [self.mesh.coord(ax) for ax in fixed]
        return tuple(r for r in range(self.mesh.size)
                     if [self.mesh.coord(ax, r) for ax in fixed] == mine)

    @property
    def group(self):
        """The process group of `gather_ranks` (made by `make_dist_mesh`:
        an axis's group, or the pod's for both `data` and `model`)."""
        ranks = self.gather_ranks
        if ranks == self.mesh.pod_ranks():
            return self.mesh.pod_group()
        return self.mesh.groups[ranks]

    @functools.cached_property
    def owner(self) -> bool:
        """Whether this rank is the lowest in the world holding its block."""
        return collectives._owner(self.mesh, self._spec, self.shape,
                                  self.mesh.rank, range(self.mesh.size))


def _gather_whole(block: torch.Tensor, pl: Placement) -> torch.Tensor:
    parts = [torch.empty_like(block) for _ in pl.gather_ranks]
    collectives._all_gather(parts, block.contiguous(), pl.group)
    out = block.new_empty(pl.shape)
    for r, part in zip(pl.gather_ranks, parts):
        out[pl.block(r)] = part
    return out


class _Gather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, block, pl):
        ctx.sl = pl.block()
        return _gather_whole(block, pl)

    @staticmethod
    def backward(ctx, g):
        # every rank of the pod holds the same whole gradient: take this
        # rank's block (a copy, so the whole gradient is freed)
        return g[ctx.sl].clone(memory_format=torch.contiguous_format), None


def gather(block: torch.Tensor, pl: Placement) -> torch.Tensor:
    """The whole tensor whose block this rank holds as `block`
    (differentiable; the identity when the block is the whole)."""
    if len(pl.gather_ranks) == 1:
        return block
    return _Gather.apply(block, pl)


@torch.no_grad()
def gather_data(block: torch.Tensor, pl: Placement) -> torch.Tensor:
    """`gather` outside autograd (checkpoints, compression, re-meshing)."""
    if len(pl.gather_ranks) == 1:
        return block.detach()
    return _gather_whole(block.detach(), pl)


# ---------------------------------------------------------------------------
# gather on use
# ---------------------------------------------------------------------------

class _GatherOnUse:
    """Mixed in before a module's class by `shard_params`: reading a
    parameter named in the instance's `_placements` returns it gathered
    whole. `named_parameters` and `state_dict` read `_parameters` and so
    still see the blocks."""

    def __getattr__(self, name: str):
        value = super().__getattr__(name)
        pl = self.__dict__.get("_placements", {}).get(name)
        return value if pl is None else gather(value, pl)


_GATHERED: Dict[type, type] = {}


def _gathered_class(cls: type) -> type:
    if issubclass(cls, _GatherOnUse):
        return cls
    if cls not in _GATHERED:
        _GATHERED[cls] = type(cls.__name__, (_GatherOnUse, cls),
                              {"__module__": cls.__module__})
    return _GATHERED[cls]


@dataclasses.dataclass(eq=False)
class ShardLayout:
    """The placement of every parameter of a sharded model, by its
    `named_parameters` name and in that order; the moments and residuals
    named alike share them."""
    mesh: Any
    placements: Dict[str, Placement]

    @property
    def pods(self) -> int:
        return int(self.mesh.shape.get("pod", 1))


def layout_of(params) -> Optional[ShardLayout]:
    """The layout `shard_params` attached to `params`, or None."""
    if isinstance(params, nn.Module):
        return params.__dict__.get("_shard_layout")
    return None


def _set_block(module: nn.Module, leaf: str, block: torch.Tensor,
               pl: Placement) -> None:
    old = module._parameters[leaf]
    if block is not old:
        module._parameters[leaf] = nn.Parameter(
            block, requires_grad=old.requires_grad)
    if len(pl.gather_ranks) > 1:
        module.__class__ = _gathered_class(type(module))
        module.__dict__.setdefault("_placements", {})[leaf] = pl
    else:
        module.__dict__.get("_placements", {}).pop(leaf, None)


def shard_params(model: nn.Module, mesh) -> nn.Module:
    """Keep, in place, only this rank's block of each parameter of `model`
    (whole on every rank when called) under
    `spec_rules.param_shardings(model, mesh)`, and gather each on use.
    Returns `model`, its `ShardLayout` attached."""
    specs = spec_rules.param_shardings(model, mesh)
    placements = {}
    for name, p in list(model.named_parameters()):
        pl = Placement(mesh, tuple(specs[name]), tuple(p.shape))
        module_name, _, leaf = name.rpartition(".")
        module = model.get_submodule(module_name)
        block = p.detach()[pl.block()]
        if tuple(block.shape) == tuple(p.shape):
            block = p                          # the whole: no copy
        else:
            block = block.clone()
        _set_block(module, leaf, block, pl)
        placements[name] = pl
    model.__dict__["_shard_layout"] = ShardLayout(mesh, placements)
    return model


# ---------------------------------------------------------------------------
# data parallelism over pods
# ---------------------------------------------------------------------------

def pod_batch(batch: Mapping[str, torch.Tensor], layout: ShardLayout
              ) -> Dict[str, torch.Tensor]:
    """This pod's rows of a global batch: the batch splits over `pod`."""
    pods = layout.pods
    if pods == 1:
        return dict(batch)
    c = layout.mesh.coord("pod")
    out = {}
    for k, v in batch.items():
        if v.shape[0] % pods:
            raise ValueError(f"batch {k} of {v.shape[0]} rows does not "
                             f"split over {pods} pods")
        n = v.shape[0] // pods
        out[k] = v[c * n:(c + 1) * n]
    return out


@torch.no_grad()
def mean_over_pods(t: torch.Tensor, layout: ShardLayout) -> torch.Tensor:
    """The mean of `t` over the `pod` axis (an all-reduce over the ranks
    that hold the same block in the other pods), in place."""
    pods = layout.pods
    if pods == 1:
        return t
    collectives._all_reduce(t, layout.mesh.group("pod"))
    return t.div_(pods)


# ---------------------------------------------------------------------------
# trainer states: checkpoints and re-meshing
# ---------------------------------------------------------------------------

def _children(node):
    if isinstance(node, Mapping):
        return list(node.items())
    if isinstance(node, tuple) and hasattr(node, "_fields"):
        return list(zip(node._fields, node))
    if isinstance(node, (tuple, list)):
        return list(enumerate(node))
    return []


def find_layout(state) -> Optional[ShardLayout]:
    """The layout of the first sharded model in `state` (a model, or a
    tuple or mapping holding one)."""
    if isinstance(state, nn.Module):
        return layout_of(state)
    for _, v in _children(state):
        found = find_layout(v)
        if found is not None:
            return found
    return None


def _is_param_map(node, layout: ShardLayout) -> bool:
    return (isinstance(node, Mapping) and bool(node)
            and all(k in layout.placements for k in node))


def state_shardings(state) -> Dict[str, Placement]:
    """checkpoint leaf name (as `ckpt.manager.flatten` names it) ->
    `Placement` of every tensor of a trainer state that is a parameter's
    block: the model's parameters, and the entries of any mapping keyed by
    parameter names (the AdamW moments, the compression residual). Other
    tensors (the step counter) are whole on every rank."""
    layout = find_layout(state)
    out: Dict[str, Placement] = {}
    if layout is None:
        return out

    def walk(node, prefix: str) -> None:
        if isinstance(node, nn.Module):
            names = node.state_dict().keys()
        elif _is_param_map(node, layout):
            names = node.keys()
        else:
            for k, v in _children(node):
                walk(v, f"{prefix}{k}.")
            return
        for name in names:
            if name in layout.placements:
                out[prefix + name] = layout.placements[name]

    walk(state, "")
    return out


def _replaced(node, layout: ShardLayout, new: ShardLayout):
    """`node` with every parameter block re-placed from `layout` to `new`;
    a model in place, mappings and tuples rebuilt."""
    def move(t: torch.Tensor, name: str) -> torch.Tensor:
        old_pl, new_pl = layout.placements[name], new.placements[name]
        if old_pl.mesh is new_pl.mesh and old_pl.spec == new_pl.spec:
            return t
        return gather_data(t, old_pl)[new_pl.block()].clone()

    if isinstance(node, nn.Module):
        for name, p in list(node.named_parameters()):
            module_name, _, leaf = name.rpartition(".")
            module = node.get_submodule(module_name)
            _set_block(module, leaf, move(p, name), new.placements[name])
        node.__dict__["_shard_layout"] = new
        return node
    if _is_param_map(node, layout):
        return {k: move(v, k) for k, v in node.items()}
    if isinstance(node, tuple) and hasattr(node, "_fields"):
        return type(node)(*(_replaced(v, layout, new) for v in node))
    if isinstance(node, (tuple, list)):
        return type(node)(_replaced(v, layout, new) for v in node)
    if isinstance(node, Mapping):
        return {k: _replaced(v, layout, new) for k, v in node.items()}
    return node


def reshard(state, new_mesh, shardings_fn=spec_rules.param_shardings):
    """Re-place a sharded state (a model, or a trainer state holding one)
    onto `new_mesh`, a mesh over the same world: each block is gathered
    whole on the old mesh and this rank's block under
    `shardings_fn({name: whole-shaped meta tensor}, new_mesh)` kept. A
    collective: every rank calls it alike."""
    layout = find_layout(state)
    if layout is None:
        raise ValueError("reshard needs a state sharded by shard_params")
    shapes = {name: torch.empty(pl.shape, device="meta")
              for name, pl in layout.placements.items()}
    specs = shardings_fn(shapes, new_mesh)
    new = ShardLayout(new_mesh, {
        name: Placement(new_mesh, tuple(specs[name]), pl.shape)
        for name, pl in layout.placements.items()})
    return _replaced(state, layout, new)

