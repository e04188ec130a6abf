"""DiT core: the paper's deployment-schedule abstraction, BSP IR, mask-based
collective calculus, data-layout engine, dataflow pattern builders, autotuner,
and the distributed `dit_gemm` for the TPU target."""
from repro_torch.core.schedule import GEMMShape, Schedule, Tiling, build_program
from repro_torch.core.lower import (EXEC_MODES, ExecPlan, Fallback, MeshView,
                              lower_schedule, lowering_summary)
from repro_torch.core.masks import (MaskSpec, TileGroup, all_group, col_group,
                              rect_group, row_group, strided_group)
from repro_torch.core.remap import ClusterRemap, candidate_remaps, flat_mask_group
from repro_torch.core.layout import (DataLayout, PlacementScheme, SplitScheme,
                               base_layout, candidate_layouts, optimal_layout)
from repro_torch.core.ir import (BufferDecl, DMAOp, MMADOp, MulticastOp, P2POp,
                           Program, ReduceOp, Superstep)

__all__ = [
    "GEMMShape", "Schedule", "Tiling", "build_program",
    "EXEC_MODES", "ExecPlan", "Fallback", "MeshView", "lower_schedule",
    "lowering_summary",
    "MaskSpec", "TileGroup", "all_group", "col_group", "rect_group",
    "row_group", "strided_group",
    "ClusterRemap", "candidate_remaps", "flat_mask_group",
    "DataLayout", "PlacementScheme", "SplitScheme", "base_layout",
    "candidate_layouts", "optimal_layout",
    "BufferDecl", "DMAOp", "MMADOp", "MulticastOp", "P2POp", "Program",
    "ReduceOp", "Superstep",
]
