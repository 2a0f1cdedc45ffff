from repro_torch.configs.base import (GLOBAL_ATTN, SSD, ArchConfig, MoEConfig,
                                      TrainHParams)
from repro_torch.configs.registry import get_config

__all__ = ["ArchConfig", "GLOBAL_ATTN", "MoEConfig", "SSD", "TrainHParams",
           "get_config"]
