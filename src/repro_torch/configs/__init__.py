# The architectures ported so far: the dense GQA family (gemma-2b, olmo-1b,
# phi4-mini-3.8b, qwen3-14b), the MoE family (deepseek-moe-16b), MLA
# (deepseek-v2-236b) and the recurrent stacks (zamba2-1.2b, xlstm-1.3b).
# The other two configs join with their block kinds (ROADMAP.md, queue 1).
from repro_torch.configs import (deepseek_moe_16b, deepseek_v2_236b, gemma_2b,
                                 olmo_1b, phi4_mini_3_8b, qwen3_14b,
                                 xlstm_1_3b, zamba2_1_2b)
from repro_torch.configs.registry import (SHAPES, SUBQUADRATIC, cells,
                                          get_config, list_archs,
                                          smoke_config)

__all__ = ["SHAPES", "SUBQUADRATIC", "cells", "get_config", "list_archs",
           "smoke_config"]
