# gemma-2b is the one architecture of the first port slice; the other nine
# configs join with their block kinds (ROADMAP.md, queue 1).
from repro_torch.configs import gemma_2b
from repro_torch.configs.registry import (SHAPES, SUBQUADRATIC, cells,
                                          get_config, list_archs,
                                          smoke_config)

__all__ = ["SHAPES", "SUBQUADRATIC", "cells", "get_config", "list_archs",
           "smoke_config"]
