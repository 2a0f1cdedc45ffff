from repro_torch.configs.base import ArchConfig, GLOBAL_ATTN, TrainHParams
from repro_torch.configs.registry import get_config

__all__ = ["ArchConfig", "GLOBAL_ATTN", "TrainHParams", "get_config"]
