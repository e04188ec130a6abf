# Every architecture of the reference: the dense GQA family (gemma-2b,
# olmo-1b, phi4-mini-3.8b, qwen3-14b), the MoE family (deepseek-moe-16b),
# MLA (deepseek-v2-236b), the recurrent stacks (zamba2-1.2b, xlstm-1.3b),
# the encoder-decoder (seamless-m4t-medium) and the VLM frontend stub
# (phi-3-vision-4.2b).
from repro_torch.configs import (deepseek_moe_16b, deepseek_v2_236b, gemma_2b,
                                 olmo_1b, phi3_vision_4_2b, phi4_mini_3_8b,
                                 qwen3_14b, seamless_m4t_medium, xlstm_1_3b,
                                 zamba2_1_2b)
from repro_torch.configs.registry import (SHAPES, SUBQUADRATIC, cells,
                                          get_config, list_archs,
                                          smoke_config)

__all__ = ["SHAPES", "SUBQUADRATIC", "cells", "get_config", "list_archs",
           "smoke_config"]
