"""Rotary embedding, training and prefill attention, and decode attention
over a dense or paged cache, one token a slot or the speculative
verify's block of them (``repro.models.attention``)."""
from __future__ import annotations

import functools
from typing import Optional

import torch

from repro_torch.kernels.flash_attention import (dense_flash_decode,
                                                dense_flash_decode_multi,
                                                flash_attention,
                                                paged_flash_decode,
                                                paged_flash_decode_multi)
from repro_torch.kernels.ref import gather_pages

__all__ = ["rope", "gather_pages", "chunked_attention", "decode_attention",
           "paged_decode_attention", "decode_attention_multi",
           "paged_decode_attention_multi"]


@functools.lru_cache(maxsize=None)
def _rope_freqs(half: int, theta: float,
                device: torch.device) -> torch.Tensor:
    """``theta ** (-i / half)``, i < half, in f32, computed on the CPU and
    copied to ``device``, so that every device rotates by the same
    angles: an f32 ``pow`` on the card may round a frequency to the next
    float, which a position in the thousands turns into ~1e-4 of the
    angle."""
    return (theta ** (-torch.arange(0, half, dtype=torch.float32)
                      / half)).to(device)


def rope(x: torch.Tensor, positions: torch.Tensor,
         theta: float) -> torch.Tensor:
    """x [b, s, h, hd]; positions [b, s] (or [s]) -> x's dtype.  Angles and
    the rotation are f32, as in the JAX version."""
    hd = x.shape[-1]
    half = hd // 2
    freqs = _rope_freqs(half, float(theta), x.device)
    if positions.dim() == 1:
        positions = positions[None, :]
    ang = positions[..., None].float() * freqs            # [b, s, half]
    cos = torch.cos(ang)[:, :, None, :]
    sin = torch.sin(ang)[:, :, None, :]
    x1, x2 = x[..., :half], x[..., half:]
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin],
                     dim=-1).to(x.dtype)


def chunked_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                      causal: bool = True, window: Optional[int] = None,
                      softcap: float = 0.0,
                      q_positions: Optional[torch.Tensor] = None,
                      kv_positions: Optional[torch.Tensor] = None,
                      scale: Optional[float] = None) -> torch.Tensor:
    """The training path's attention (``repro.models.attention
    .chunked_attention`` over query positions ``arange(sq)`` and key
    positions ``arange(sk)``), differentiable: the flash kernels on the
    card, their plain versions on the CPU.  Self-attention (sk = sq,
    causal), the encoder's (non-causal) and cross attention (any sk,
    non-causal) take the same kernels.

    q [b, sq, h, hd]; k, v [b, sk, kvh, hd] -> [b, sq, h, hd].
    ``q * scale`` is taken in f32, as the TPU kernel does
    (``chunked_attention`` scales in q's dtype first; the two agree
    exactly in f32 and whenever the scale is a power of two)."""
    for name, pos, n in (("q_positions", q_positions, q.shape[1]),
                         ("kv_positions", kv_positions, k.shape[1])):
        if pos is None:
            continue
        ar = torch.arange(n, device=pos.device)
        if pos.shape[-1] != n or not bool((pos == ar).all()):
            raise NotImplementedError(
                f"chunked_attention: {name} other than arange(s) is not "
                f"taken: the flash kernels attend at arange(sq) against "
                f"arange(sk); offset positions are the ring's "
                f"(kernels/ring_attention.py), the verify's the decode "
                f"reads' (decode_attention_multi)")
    return flash_attention(q, k, v, causal=causal, window=window,
                           softcap=softcap, scale=scale)


def paged_decode_attention(q: torch.Tensor, k_pages: torch.Tensor,
                           v_pages: torch.Tensor, tables: torch.Tensor,
                           pos: torch.Tensor, *, softcap: float = 0.0,
                           scale: Optional[float] = None) -> torch.Tensor:
    """Single-token decode attention through a block table (global layers
    of a paged cache); the CUDA kernel on the card, its plain version on
    the CPU."""
    return paged_flash_decode(q, k_pages, v_pages, tables, pos,
                              softcap=softcap, scale=scale)


def decode_attention(q: torch.Tensor, k_cache: torch.Tensor,
                     v_cache: torch.Tensor, pos: torch.Tensor, *,
                     window: Optional[int] = None, softcap: float = 0.0,
                     scale: Optional[float] = None,
                     ring: bool = False) -> torch.Tensor:
    """Single-token decode attention over a dense cache: q [b, 1, h, hd];
    k_cache/v_cache [b, S, kvh, hd]; pos [b] int32, the new token's
    position -> [b, 1, h, hd].  ``ring``: S = window slots written
    circularly (slot = pos % S).  The paged decode kernel reads the cache
    through a block-table view on the card
    (:func:`~repro_torch.kernels.flash_attention.dense_flash_decode`);
    JAX's masked softmax in f32 on the CPU."""
    return dense_flash_decode(q, k_cache, v_cache, pos, window=window,
                              softcap=softcap, scale=scale, ring=ring)


def decode_attention_multi(q: torch.Tensor, k_cache: torch.Tensor,
                           v_cache: torch.Tensor, pos: torch.Tensor, *,
                           softcap: float = 0.0,
                           scale: Optional[float] = None) -> torch.Tensor:
    """The speculative verify's attention over a dense cache: q [b, qn, h,
    hd] holds ``qn`` consecutive tokens at positions ``pos + j``, whose
    k/v the caller wrote first; slot s is visible to query j iff
    ``s <= pos + j`` -> [b, qn, h, hd].  The paged decode kernel with the
    queries folded into its batch on the card
    (:func:`~repro_torch.kernels.flash_attention.dense_flash_decode_multi`);
    JAX's masked softmax in f32 on the CPU."""
    return dense_flash_decode_multi(q, k_cache, v_cache, pos,
                                    softcap=softcap, scale=scale)


def paged_decode_attention_multi(q: torch.Tensor, k_pages: torch.Tensor,
                                 v_pages: torch.Tensor, tables: torch.Tensor,
                                 pos: torch.Tensor, *, softcap: float = 0.0,
                                 scale: Optional[float] = None
                                 ) -> torch.Tensor:
    """:func:`decode_attention_multi` through a block table (global layers
    of a paged cache)."""
    return paged_flash_decode_multi(q, k_pages, v_pages, tables, pos,
                                    softcap=softcap, scale=scale)
