from repro_torch.configs.base import (CROSS_ATTN, GLOBAL_ATTN, LOCAL_ATTN,
                                      RGLRU, SSD, ArchConfig, MoEConfig,
                                      TrainHParams)
from repro_torch.configs.registry import ASSIGNED, get_config

__all__ = ["ASSIGNED", "ArchConfig", "CROSS_ATTN", "GLOBAL_ATTN",
           "LOCAL_ATTN", "MoEConfig", "RGLRU", "SSD", "TrainHParams",
           "get_config"]
