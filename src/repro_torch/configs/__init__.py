from repro_torch.configs.base import (GLOBAL_ATTN, LOCAL_ATTN, RGLRU, SSD,
                                      ArchConfig, MoEConfig, TrainHParams)
from repro_torch.configs.registry import get_config

__all__ = ["ArchConfig", "GLOBAL_ATTN", "LOCAL_ATTN", "MoEConfig", "RGLRU",
           "SSD", "TrainHParams", "get_config"]
