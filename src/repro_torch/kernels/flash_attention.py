"""Paged decode attention: wrapper of the CUDA kernel ``csrc/paged_decode.cu``.

Counterpart of ``repro.kernels.flash_attention.paged_flash_decode``, with
the same signature and layouts.  A CPU tensor takes the plain version
(:func:`repro_torch.kernels.ref.paged_decode_attention_ref`); a CUDA
tensor launches the kernel or raises.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.ref import paged_decode_attention_ref

_DTYPES = {torch.float32: _build.DTYPE_F32, torch.bfloat16: _build.DTYPE_BF16}
GROUPS = (1, 2, 4, 8)
HEAD_DIMS = (32, 64, 128)


def paged_flash_decode(q: torch.Tensor, k_pages: torch.Tensor,
                       v_pages: torch.Tensor, tables: torch.Tensor,
                       pos: torch.Tensor, *, softcap: float = 0.0,
                       scale: Optional[float] = None) -> torch.Tensor:
    """Single-token decode attention reading the KV cache through a block
    table.

    q [b, 1, h, hd]; k_pages/v_pages [P, page, kvh, hd] (q's dtype, f32 or
    bf16); tables [b, nb] int32 (physical page of logical block i; 0 is
    the null page); pos [b] int32 -> [b, 1, h, hd]."""
    tensors = (q, k_pages, v_pages, tables, pos)
    if all(t.device.type == "cpu" for t in tensors):
        return paged_decode_attention_ref(q, k_pages, v_pages, tables, pos,
                                          softcap=softcap, scale=scale)
    if q.device.type != "cuda" or any(t.device != q.device for t in tensors):
        raise ValueError(
            "paged_flash_decode: all tensors must be on the CPU or on the "
            f"same CUDA device, got {[str(t.device) for t in tensors]}")
    b, one, h, hd = q.shape
    npages, page, kvh, hd_k = k_pages.shape
    if one != 1 or hd_k != hd or v_pages.shape != k_pages.shape:
        raise ValueError(
            f"paged_flash_decode: q {tuple(q.shape)}, k_pages "
            f"{tuple(k_pages.shape)}, v_pages {tuple(v_pages.shape)} do not "
            f"match [b, 1, h, hd] and [P, page, kvh, hd]")
    if q.dtype not in _DTYPES or k_pages.dtype != q.dtype \
            or v_pages.dtype != q.dtype:
        raise TypeError(
            f"paged_flash_decode kernel takes f32 or bf16 q/k/v of one "
            f"dtype, got {q.dtype}/{k_pages.dtype}/{v_pages.dtype}")
    if h % kvh or h // kvh not in GROUPS or hd not in HEAD_DIMS:
        raise ValueError(
            f"paged_flash_decode kernel supports h/kvh in {GROUPS} and hd "
            f"in {HEAD_DIMS}, got h={h} kvh={kvh} hd={hd}")
    if tables.dtype != torch.int32 or pos.dtype != torch.int32 \
            or tables.dim() != 2 or tables.shape[0] != b \
            or pos.shape != (b,):
        raise TypeError(
            f"paged_flash_decode takes int32 tables [b, nb] and pos [b] "
            f"with b={b}, got {tables.dtype} {tuple(tables.shape)} and "
            f"{pos.dtype} {tuple(pos.shape)}")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("paged_flash_decode kernel takes contiguous tensors")
    scale = hd ** -0.5 if scale is None else scale
    out = torch.empty_like(q)
    lib = _build.library()
    rc = lib.repro_paged_decode(
        q.data_ptr(), k_pages.data_ptr(), v_pages.data_ptr(),
        tables.data_ptr(), pos.data_ptr(), out.data_ptr(), b, kvh, h // kvh,
        hd, page, tables.shape[1], scale, softcap, _DTYPES[q.dtype],
        _build.stream_ptr(q))
    _build.check(rc, "paged_decode kernel launch")
    _build.LAUNCHES["paged_decode"] += 1
    return out
