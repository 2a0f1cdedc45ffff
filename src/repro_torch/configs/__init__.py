from repro_torch.configs.base import ArchConfig, GLOBAL_ATTN
from repro_torch.configs.registry import get_config

__all__ = ["ArchConfig", "GLOBAL_ATTN", "get_config"]
