"""AdamW + schedules + global-norm clipping over a model's named parameters.

Port of `repro/optim/adamw.py`. The reference maps over a parameter pytree;
here the parameters are an ordered name -> tensor mapping (an `nn.Module`'s
`named_parameters()`, or any mapping of that shape), and the gradients and
both moments are mappings with the same names. The rules and numerics are
the reference's: moments in fp32 on the parameters' device, the update in
fp32 and one cast back to the parameter dtype, the schedule and the bias
corrections in fp32.

Unlike the reference's pure function, `apply` updates the parameters and
the moments in place: at gemma-2b width a second copy of them would cost
25 GB of device memory. The returned parameters and moment mappings are the
ones passed in; the step counter is a new tensor.

On a model sharded by `parallel.sharded.shard_params` the moments are made
at the blocks' shapes and the update is the same elementwise arithmetic on
each rank's blocks. The global norm counts each distinct block once (on
the lowest rank holding it) and sums the squares over the world. It sums
them in fp64, each tensor's and then the tensors', and rounds the norm to
fp32 once, so the norm does not depend on how the mesh cuts the tensors
into blocks (an fp32 sum would round differently per cut) and a run
re-meshed from a checkpoint continues as it would have.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, Mapping, NamedTuple, Optional, Tuple, Union

import torch
from torch import nn

from repro_torch.core import collectives
from repro_torch.obs.trace import profile_scope
from repro_torch.parallel import sharded

Params = Union[nn.Module, Mapping[str, torch.Tensor]]


class AdamWState(NamedTuple):
    step: torch.Tensor                 # 0-d int32
    mu: Dict[str, torch.Tensor]        # fp32, one per parameter name
    nu: Dict[str, torch.Tensor]


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.01
    clip_norm: Optional[float] = 1.0
    warmup_steps: int = 100
    total_steps: int = 10_000
    schedule: str = "cosine"       # cosine | linear | constant


def named(params: Params) -> Dict[str, torch.Tensor]:
    """The ordered name -> tensor mapping the optimizer walks."""
    if isinstance(params, nn.Module):
        return dict(params.named_parameters())
    return dict(params)


def lr_at(cfg: AdamWConfig, step: torch.Tensor) -> torch.Tensor:
    step = step.float()
    warm = torch.clamp((step + 1) / max(1, cfg.warmup_steps), max=1.0)
    frac = torch.clamp((step - cfg.warmup_steps)
                       / max(1, cfg.total_steps - cfg.warmup_steps), 0.0, 1.0)
    if cfg.schedule == "cosine":
        decay = 0.5 * (1 + torch.cos(math.pi * frac))
    elif cfg.schedule == "linear":
        decay = 1.0 - frac
    else:
        decay = 1.0
    return cfg.lr * warm * decay


# elements a time in the fp64 sum of squares (bounds its fp64 copy to
# 128 MiB whatever the tensor; it moves as many bytes a step as an fp32
# square and sum did)
_NORM_CHUNK = 1 << 24


def _sum_squares(g: torch.Tensor) -> torch.Tensor:
    flat = g.detach().reshape(-1)
    total = torch.zeros((), dtype=torch.float64, device=g.device)
    for part in flat.split(_NORM_CHUNK):
        norm = torch.linalg.vector_norm(part, dtype=torch.float64)
        total += norm * norm
    return total


def global_norm(tree: Mapping[str, torch.Tensor], layout=None
                ) -> torch.Tensor:
    """The fp32 L2 norm over every tensor of `tree`; with a sharded
    model's `layout`, over the blocks of the whole tensors its ranks
    hold."""
    total = None
    for name, g in tree.items():
        if layout is not None and not layout.placements[name].owner:
            continue
        sq = _sum_squares(g)
        total = sq if total is None else total + sq
    if total is None:
        total = torch.zeros((), dtype=torch.float64,
                            device=next(iter(tree.values())).device)
    if layout is not None and layout.mesh.size > 1:
        collectives._all_reduce(total)
    return torch.sqrt(total).float()


def clip_by_global_norm(tree: Mapping[str, torch.Tensor], max_norm: float,
                        layout=None
                        ) -> Tuple[Dict[str, torch.Tensor], torch.Tensor]:
    with profile_scope("optim.clip"):
        norm = global_norm(tree, layout)
        factor = torch.clamp(max_norm / (norm + 1e-9), max=1.0)
        return ({k: (g.float() * factor).to(g.dtype)
                 for k, g in tree.items()}, norm)


def init(params: Params) -> AdamWState:
    ps = named(params)
    device = next(iter(ps.values())).device

    def zeros():
        return {k: torch.zeros(p.shape, dtype=torch.float32, device=p.device)
                for k, p in ps.items()}
    return AdamWState(step=torch.zeros((), dtype=torch.int32, device=device),
                      mu=zeros(), nu=zeros())


@torch.no_grad()
def apply(cfg: AdamWConfig, params: Params,
          grads: Mapping[str, torch.Tensor], state: AdamWState
          ) -> Tuple[Params, AdamWState, dict]:
    """One AdamW step, in place, named `optim.adamw` for the profiler.
    Returns (params, state, metrics) with metrics `lr` and, when clipping,
    `grad_norm` (before clipping)."""
    with profile_scope("optim.adamw"):
        metrics = {}
        if cfg.clip_norm is not None:
            grads, gnorm = clip_by_global_norm(grads, cfg.clip_norm,
                                               sharded.layout_of(params))
            metrics["grad_norm"] = gnorm
        step = state.step + 1
        lr = lr_at(cfg, step)
        metrics["lr"] = lr
        b1c = 1 - cfg.b1 ** step.float()
        b2c = 1 - cfg.b2 ** step.float()
        for name, p in named(params).items():
            gf = grads[name].float()
            m = state.mu[name].mul_(cfg.b1).add_((1 - cfg.b1) * gf)
            v = state.nu[name].mul_(cfg.b2).add_((1 - cfg.b2) * gf * gf)
            mhat = m / b1c
            vhat = v / b2c
            pf = p.float()
            p.copy_(pf - lr * (mhat / (torch.sqrt(vhat) + cfg.eps)
                               + cfg.weight_decay * pf))
        return params, AdamWState(step=step, mu=state.mu, nu=state.nu), metrics
