"""Grouped (per-expert) matmul: the wrapper of the CUDA kernel
``csrc/moe_gmm.cu`` and the autograd Function of the MoE path.

Counterpart of ``repro.kernels.moe_gmm.moe_gmm``: x [E, C, D] @ w
[E, D, F] -> [E, C, F] per expert, f32 accumulation, output in x's dtype.
A CPU tensor takes the plain version
(:func:`repro_torch.kernels.ref.moe_gmm_ref`); a CUDA tensor launches the
kernel or raises.  JAX has no backward kernel (XLA differentiates the
einsums); the two gradients are the same grouped product on transposed
operands (``dx = dy @ w^T``, ``dw = x^T @ dy`` per expert), so
:func:`grouped_matmul`'s backward launches the same kernel on contiguous
transposed copies.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.ref import moe_gmm_ref

_DTYPES = {torch.float32: _build.DTYPE_F32, torch.bfloat16: _build.DTYPE_BF16}


def _blocks(c: int, f: int):
    """(bm, bn, bk) of one expert's [c, d] @ [d, f]: the tile loop's
    compiled sizes (``csrc/tile_mm.cuh``), halved where the capacity or
    the width is small, so fewer rows and columns are masked."""
    return (64 if c <= 64 else 128), (64 if f <= 64 else 128), 32


def moe_gmm(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """x [E, C, D] @ w [E, D, F] -> [E, C, F] in x's dtype (f32 or bf16,
    w of the same dtype).  No autograd (see :func:`grouped_matmul`)."""
    if x.dim() != 3 or w.dim() != 3 or x.shape[0] != w.shape[0] \
            or x.shape[2] != w.shape[1]:
        raise ValueError(f"moe_gmm: shapes {tuple(x.shape)} @ "
                         f"{tuple(w.shape)} are not [E, C, D] @ [E, D, F]")
    if _build.on_cpu("moe_gmm", x, w):
        return moe_gmm_ref(x, w)
    if x.dtype not in _DTYPES or w.dtype != x.dtype:
        raise TypeError(f"moe_gmm kernel takes f32 or bf16 x and w of one "
                        f"dtype, got {x.dtype} and {w.dtype}")
    if not (x.is_contiguous() and w.is_contiguous()):
        raise ValueError("moe_gmm kernel takes contiguous x and w")
    e, c, d = x.shape
    f = w.shape[2]
    out = torch.empty(e, c, f, dtype=x.dtype, device=x.device)
    if out.numel() == 0 or d == 0:
        return out.zero_()
    bm, bn, bk = _blocks(c, f)
    rc = _build.library().repro_moe_gmm(
        x.data_ptr(), w.data_ptr(), out.data_ptr(), e, c, d, f, bm, bn, bk,
        _DTYPES[x.dtype], _build.stream_ptr(x))
    _build.check(rc, f"moe_gmm kernel launch (blocks {bm}x{bn}x{bk})")
    _build.LAUNCHES["moe_gmm"] += 1
    return out


def moe_gmm_bwd(x: torch.Tensor, w: torch.Tensor, dy: torch.Tensor, *,
                need_dx: bool = True, need_dw: bool = True):
    """Gradients of :func:`moe_gmm` given dy [E, C, F]: (dx [E, C, D],
    dw [E, D, F]) in the inputs' dtype, each None when not needed; one
    kernel launch each."""
    dy = dy.contiguous()
    dx = moe_gmm(dy, w.transpose(1, 2).contiguous()) if need_dx else None
    dw = moe_gmm(x.transpose(1, 2).contiguous(), dy) if need_dw else None
    return dx, dw


class GroupedMatmulFunction(torch.autograd.Function):
    """Forward and backward: the grouped-matmul kernel (plain versions on
    the CPU).  Saves x and w."""

    @staticmethod
    def forward(ctx, x, w):
        ctx.save_for_backward(x, w)
        return moe_gmm(x, w)

    @staticmethod
    def backward(ctx, dy):
        x, w = ctx.saved_tensors
        return moe_gmm_bwd(x, w, dy, need_dx=ctx.needs_input_grad[0],
                           need_dw=ctx.needs_input_grad[1])


def grouped_matmul(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Differentiable per-expert product x [E, C, D] @ w [E, D, F] ->
    [E, C, F] (the expert einsums ``ecd,edf->ecf`` of JAX's ``moe_ffn``)."""
    return GroupedMatmulFunction.apply(x.contiguous(), w.contiguous())
