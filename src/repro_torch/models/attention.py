"""Rotary embedding and paged decode attention (``repro.models.attention``
for the decode path)."""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels.flash_attention import paged_flash_decode
from repro_torch.kernels.ref import gather_pages

__all__ = ["rope", "gather_pages", "paged_decode_attention"]


def rope(x: torch.Tensor, positions: torch.Tensor,
         theta: float) -> torch.Tensor:
    """x [b, s, h, hd]; positions [b, s] (or [s]) -> x's dtype.  Angles and
    the rotation are f32, as in the JAX version."""
    hd = x.shape[-1]
    half = hd // 2
    freqs = theta ** (-torch.arange(0, half, dtype=torch.float32,
                                    device=x.device) / half)
    if positions.dim() == 1:
        positions = positions[None, :]
    ang = positions[..., None].float() * freqs            # [b, s, half]
    cos = torch.cos(ang)[:, :, None, :]
    sin = torch.sin(ang)[:, :, None, :]
    x1, x2 = x[..., :half], x[..., half:]
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin],
                     dim=-1).to(x.dtype)


def paged_decode_attention(q: torch.Tensor, k_pages: torch.Tensor,
                           v_pages: torch.Tensor, tables: torch.Tensor,
                           pos: torch.Tensor, *, softcap: float = 0.0,
                           scale: Optional[float] = None) -> torch.Tensor:
    """Single-token decode attention through a block table; the CUDA
    kernel on the card, its plain version on the CPU."""
    return paged_flash_decode(q, k_pages, v_pages, tables, pos,
                              softcap=softcap, scale=scale)
