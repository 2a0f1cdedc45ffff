"""Tensor-model-parallel primitives of ``repro.core.tmp`` at tp=1 (the
slice runs one device): the norm, the embedding and greedy sampling."""
from __future__ import annotations

import torch

from repro_torch.kernels.rmsnorm import rmsnorm


def rms_norm(x: torch.Tensor, scale: torch.Tensor,
             eps: float = 1e-5) -> torch.Tensor:
    """``repro.core.tmp.rms_norm``: f32 math, ``(1 + scale)``, output in
    x's dtype.  Runs the CUDA kernel on a CUDA tensor."""
    return rmsnorm(x, scale, eps=eps)


def vocab_parallel_embed(tokens: torch.Tensor,
                         embed: torch.Tensor) -> torch.Tensor:
    """tokens [...] -> [..., D].  At tp=1 the vocab shard is the whole
    table and the completing AllReduce is the identity."""
    return embed[tokens.long()]


def greedy_token(logits: torch.Tensor) -> torch.Tensor:
    """[b, V] -> [b] int32; the first maximum wins, as ``jnp.argmax``."""
    return torch.argmax(logits, dim=-1).to(torch.int32)
