"""One GLOBAL_ATTN + SwiGLU layer at tp=1: the training residual parts
(``repro.models.blocks.make_attn_part`` / ``make_mlp_part``) and the decode
step on a paged KV cache (``decode_fn``).  Plain matrix products stay
``torch.matmul``, as the JAX package left them to XLA."""
from __future__ import annotations

from typing import Callable, Dict

import torch
import torch.nn.functional as F

from repro_torch.configs.base import ArchConfig
from repro_torch.core.tmp import rms_norm
from repro_torch.models.attention import (chunked_attention,
                                         paged_decode_attention, rope)


def _qkv(cfg: ArchConfig, p: Dict[str, torch.Tensor], h: torch.Tensor,
         positions: torch.Tensor):
    """h [b, s, d] -> q [b, s, H, hd], k, v [b, s, KV, hd]; rope on q, k."""
    b, s, _ = h.shape
    hd = cfg.resolved_head_dim
    q = torch.matmul(h, p["wq"]).reshape(b, s, cfg.num_heads, hd)
    k = torch.matmul(h, p["wk"]).reshape(b, s, cfg.num_kv_heads, hd)
    v = torch.matmul(h, p["wv"]).reshape(b, s, cfg.num_kv_heads, hd)
    return (rope(q, positions, cfg.rope_theta),
            rope(k, positions, cfg.rope_theta), v)


def _attn_out(cfg: ArchConfig, p: Dict[str, torch.Tensor],
              attn: torch.Tensor) -> torch.Tensor:
    b, s = attn.shape[:2]
    return torch.matmul(
        attn.reshape(b, s, cfg.num_heads * cfg.resolved_head_dim), p["wo"])


def mlp_part(cfg: ArchConfig, p: Dict[str, torch.Tensor],
             x: torch.Tensor) -> torch.Tensor:
    """Residual delta of norm + SwiGLU (``make_mlp_part`` at tp=1)."""
    h = rms_norm(x, p["ln2"], cfg.norm_eps)
    a = F.silu(torch.matmul(h, p["wg"])) * torch.matmul(h, p["wu"])
    return torch.matmul(a, p["wd"])


def make_attn_part(cfg: ArchConfig) -> Callable:
    """``part(p, x, positions) -> delta``: norm, QKV + rope, causal
    attention, ``wo`` (``blocks.py`` ``make_attn_part`` for GLOBAL_ATTN at
    tp=1, no post-norm)."""
    def part(p, x, positions):
        h = rms_norm(x, p["ln"], cfg.norm_eps)
        q, k, v = _qkv(cfg, p, h, positions)
        o = chunked_attention(q, k, v, causal=True, window=None,
                              softcap=cfg.attn_softcap)
        return _attn_out(cfg, p, o)

    return part


def decode_fn(cfg: ArchConfig, p: Dict[str, torch.Tensor], x: torch.Tensor,
              k_pool: torch.Tensor, v_pool: torch.Tensor, pos: torch.Tensor,
              tables: torch.Tensor) -> torch.Tensor:
    """x [b, 1, d]; k_pool/v_pool [pages, page, kvh, hd] (this layer's
    pools); pos [b] int32; tables [b, nb] int32 -> x [b, 1, d].

    Writes the new token's k/v into the pools IN PLACE (the JAX version
    returns updated pools).  Inactive slots carry all-zero tables and write
    the null page 0, which every reader masks by position."""
    b = x.shape[0]
    h = rms_norm(x, p["ln"], cfg.norm_eps)
    q, k, v = _qkv(cfg, p, h, pos[:, None])
    page = k_pool.shape[1]
    pos_l = pos.long()
    phys = tables.long()[torch.arange(b, device=x.device), pos_l // page]
    off = pos_l % page
    k_pool[phys, off] = k[:, 0].to(k_pool.dtype)
    v_pool[phys, off] = v[:, 0].to(v_pool.dtype)
    o = paged_decode_attention(q, k_pool, v_pool, tables, pos,
                               softcap=cfg.attn_softcap)
    x = x + _attn_out(cfg, p, o)
    return x + mlp_part(cfg, p, x)
