"""Architecture configuration: the port's own copy of the part of
``repro.configs.base.ArchConfig`` that dense all-global-attention models
use.  Field names and derived values match the JAX package's, so a config
means the same model in both; the fields of the other families (MoE, SSM,
RG-LRU, local windows, encoders) arrive with their layer kinds."""
from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Tuple

# Layer kinds used in ``layer_pattern`` (repeating cycle over the stack).
GLOBAL_ATTN = "global"      # full causal self attention


def _round_up(x: int, m: int) -> int:
    return (x + m - 1) // m * m


@dataclass(frozen=True)
class ArchConfig:
    name: str
    family: str                      # dense | ...
    num_layers: int
    d_model: int
    num_heads: int
    num_kv_heads: int
    d_ff: int
    vocab_size: int
    head_dim: int = 0                # 0 -> d_model // num_heads
    layer_pattern: Tuple[str, ...] = (GLOBAL_ATTN,)
    attn_softcap: float = 0.0        # attention logit softcap (0 = off)
    final_softcap: float = 0.0       # final logit softcap (0 = off)
    rope_theta: float = 10000.0
    tie_embeddings: bool = False
    post_norms: bool = False         # sandwich norms
    norm_eps: float = 1e-5
    dtype: str = "bfloat16"
    source: str = ""

    @property
    def resolved_head_dim(self) -> int:
        if self.head_dim:
            return self.head_dim
        return self.d_model // self.num_heads if self.num_heads else 0

    def padded_vocab(self, multiple: int = 256) -> int:
        return _round_up(self.vocab_size, multiple)

    def replace(self, **kw) -> "ArchConfig":
        return dataclasses.replace(self, **kw)

    def reduced(self) -> "ArchConfig":
        """Tiny same-family config for CPU tests (the values of the JAX
        package's ``ArchConfig.reduced`` for these fields)."""
        return self.replace(
            name=self.name + "-smoke",
            num_layers=min(self.num_layers, 2 * len(self.layer_pattern)),
            d_model=128,
            num_heads=4,
            num_kv_heads=min(self.num_kv_heads, 2) if self.num_kv_heads else 0,
            d_ff=256,
            vocab_size=512,
            head_dim=32,
        )
