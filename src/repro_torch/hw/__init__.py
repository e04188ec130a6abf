from repro_torch.hw.config import (
    AcceleratorConfig,
    HBMConfig,
    NoCConfig,
    TileConfig,
    TPUChipConfig,
    TPU_V5E,
    get_accelerator,
    softhier_a100,
    softhier_gh200,
    tpu_pod_as_accelerator,
)

__all__ = [
    "AcceleratorConfig",
    "HBMConfig",
    "NoCConfig",
    "TileConfig",
    "TPUChipConfig",
    "TPU_V5E",
    "get_accelerator",
    "softhier_a100",
    "softhier_gh200",
    "tpu_pod_as_accelerator",
]
