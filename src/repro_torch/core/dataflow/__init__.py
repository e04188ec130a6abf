"""Dataflow pattern builders (paper §3.3.2): lower a `Schedule` to the BSP
`Program` the SoftHier simulator executes and the cost model prices.

The same patterns run on real JAX device meshes via `repro_torch.core.gemm`;
docs/dataflows.md tabulates the mode-by-mode collective patterns,
divisibility preconditions, and fallback behavior.
"""
from repro_torch.core.dataflow import baseline, hierarchical, splitk, summa, systolic

__all__ = ["baseline", "hierarchical", "splitk", "summa", "systolic"]
