"""Plain PyTorch versions of the port's kernels.

The kernel wrappers route CPU tensors here; the tests hold these against
the JAX package, and ``chip_smoke.py`` holds each CUDA kernel against its
plain version on the card.  They run on any device.
"""
from __future__ import annotations

from typing import Optional

import torch

NEG_INF = -1e30


def rmsnorm_ref(x: torch.Tensor, scale: torch.Tensor,
                eps: float = 1e-5) -> torch.Tensor:
    """``x * rsqrt(mean(x^2) + eps) * (1 + scale)`` in f32, cast back to
    x's dtype (``repro.kernels.ref.rmsnorm_ref``)."""
    xf = x.float()
    var = xf.square().mean(dim=-1, keepdim=True)
    return (xf * torch.rsqrt(var + eps)
            * (1.0 + scale.float())).to(x.dtype)


def gather_pages(pages: torch.Tensor, tables: torch.Tensor) -> torch.Tensor:
    """Slot-contiguous KV view of a page pool.

    pages [P, page, kvh, hd]; tables [b, nb] -> [b, nb * page, kvh, hd]."""
    g = pages[tables.long()]                 # [b, nb, page, kvh, hd]
    b, nb, page, kvh, hd = g.shape
    return g.reshape(b, nb * page, kvh, hd)


def paged_decode_attention_ref(q: torch.Tensor, k_pages: torch.Tensor,
                               v_pages: torch.Tensor, tables: torch.Tensor,
                               pos: torch.Tensor, *, softcap: float = 0.0,
                               scale: Optional[float] = None) -> torch.Tensor:
    """Single-token decode attention through a block table: gather the
    slot's pages, mask positions after ``pos``, softmax in f32.

    q [b, 1, h, hd]; k_pages/v_pages [P, page, kvh, hd]; tables [b, nb];
    pos [b] -> [b, 1, h, hd] in q's dtype.  ``q * scale`` is taken in f32,
    as the TPU kernel does (``flash_attention.py:160``)."""
    b, _, h, hd = q.shape
    kvh = k_pages.shape[2]
    g = h // kvh
    scale = hd ** -0.5 if scale is None else scale
    k = gather_pages(k_pages, tables).float()
    v = gather_pages(v_pages, tables).float()
    qf = q.float().reshape(b, kvh, g, hd) * scale
    s = torch.einsum("bkgh,bskh->bkgs", qf, k)
    if softcap:
        s = softcap * torch.tanh(s / softcap)
    slots = torch.arange(k.shape[1], device=q.device)[None, :]
    valid = slots <= pos.long()[:, None]                    # [b, S]
    s = torch.where(valid[:, None, None, :], s,
                    torch.full_like(s, NEG_INF))
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("bkgs,bskh->bkgh", p, v)
    return out.reshape(b, 1, h, hd).to(q.dtype)
