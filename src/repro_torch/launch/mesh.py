"""Host mesh construction and device resolution.

The reference builds a `jax.make_mesh` over the host's devices. This slice
runs on one device, so the host mesh is a 1x1 record exposing what the
lowering and the mode bodies read: `.shape[axis]`, `.axis_names` and the
`.device` the tensors live on.
"""
from __future__ import annotations

import dataclasses
from typing import Mapping, Tuple

import torch


@dataclasses.dataclass(frozen=True)
class HostMesh:
    device: torch.device
    axis_names: Tuple[str, ...] = ("data", "model")
    shape: Mapping[str, int] = dataclasses.field(
        default_factory=lambda: {"data": 1, "model": 1})


def resolve_device(device="cuda") -> torch.device:
    """The device an entry point runs on: the card unless the caller asked
    for the CPU. With no card and no CPU request this raises — nothing
    falls back to the CPU."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("no CUDA device is available; pass device='cpu' "
                           "(--device cpu) to run on the CPU")
    return dev


def make_host_mesh(device="cuda") -> HostMesh:
    """The 1x1 ('data', 'model') mesh of one device."""
    return HostMesh(device=resolve_device(device))
