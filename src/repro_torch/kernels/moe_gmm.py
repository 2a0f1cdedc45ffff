"""Grouped (per-expert) matmul: the wrapper of the CUDA kernel
``csrc/moe_gmm.cu`` and the autograd Function of the MoE path.

Counterpart of ``repro.kernels.moe_gmm.moe_gmm``: x [E, C, D] @ w
[E, D, F] -> [E, C, F] per expert, f32 accumulation, output in x's dtype.
A CPU tensor takes the plain version
(:func:`repro_torch.kernels.ref.moe_gmm_ref`); a CUDA tensor launches the
kernel or raises.  JAX has no backward kernel (XLA differentiates the
einsums); the two gradients are grouped products of the tensors training
already holds (``dx = dy @ w^T``, ``dw = x^T @ dy`` per expert).  On the
tensor-core tile (``csrc/gemm_tc.cuh``, bf16 operands TMA can describe:
:func:`repro_torch.kernels.autotune.gemm_path`) each is one launch that
reads w as a K-major B and x as an MN-major A where they lie; on the
other tiles (f32, or bf16 TMA cannot describe) the launch reads
contiguous transposed copies.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build, autotune
from repro_torch.kernels.ref import moe_gmm_ref

_DTYPES = {torch.float32: _build.DTYPE_F32, torch.bfloat16: _build.DTYPE_BF16}


def _blocks(m: int, n: int, path: str):
    """(bm, bn, bk) of one expert's [m, k] @ [k, n]: on the tensor-core
    tile 128 x 256 where n is wider than 128 (at granite's products 11-14%
    faster than 128 x 128 on the card), else 128 x 128; on
    ``csrc/tile_mm.cuh`` its compiled sizes, halved where the capacity or
    the width is small, so fewer rows and columns are masked."""
    if path == autotune.WGMMA:
        return autotune.TC_BLOCKS[1] if n > 128 else autotune.TC_BLOCKS[0]
    return (64 if m <= 64 else 128), (64 if n <= 64 else 128), 32


def _gmm_check(what: str, a: torch.Tensor, b: torch.Tensor, *,
               ta: bool = False, tb: bool = False):
    """What the kernels take (any device): f32 or bf16 a and b of one
    dtype, both contiguous, op(a) [E, M, K] @ op(b) [E, K, N] where op
    transposes the last two dims of a (``ta``) or b (``tb``)."""
    if a.dtype not in _DTYPES or b.dtype != a.dtype:
        raise TypeError(f"{what} kernel takes f32 or bf16 operands of one "
                        f"dtype, got {a.dtype} and {b.dtype}")
    dims_ok = a.dim() == 3 and b.dim() == 3 and a.shape[0] == b.shape[0]
    if not dims_ok or a.shape[1 if ta else 2] != b.shape[2 if tb else 1]:
        raise ValueError(
            f"{what}: shapes {tuple(a.shape)}{'^T' if ta else ''} @ "
            f"{tuple(b.shape)}{'^T' if tb else ''} are not [E, M, K] @ "
            f"[E, K, N]")
    if not (a.is_contiguous() and b.is_contiguous()):
        raise ValueError(
            f"{what} kernel takes contiguous operands, each read in its "
            f"stored layout (strides {a.stride()} and {b.stride()})")


def kernel_operands(a: torch.Tensor, b: torch.Tensor, *, ta: bool = False,
                    tb: bool = False):
    """What one launch of op(a) @ op(b) is given: (a, b, ta, tb, path).
    The tensor-core tile reads the operands where they lie, in either
    layout; the other tiles read only a [E, M, K] and b [E, K, N], so a
    transposed operand becomes a contiguous transposed copy there."""
    path = autotune.gemm_path(a, b)
    if path != autotune.WGMMA:
        if ta:
            a, ta = a.transpose(1, 2).contiguous(), False
        if tb:
            b, tb = b.transpose(1, 2).contiguous(), False
    return a, b, ta, tb, path


def _launch(a: torch.Tensor, b: torch.Tensor, *, ta: bool = False,
            tb: bool = False) -> torch.Tensor:
    """op(a) @ op(b) per expert on the card: one launch."""
    _gmm_check("moe_gmm", a, b, ta=ta, tb=tb)
    a, b, ta, tb, path = kernel_operands(a, b, ta=ta, tb=tb)
    e = a.shape[0]
    m, k = (a.shape[2], a.shape[1]) if ta else (a.shape[1], a.shape[2])
    n = b.shape[1] if tb else b.shape[2]
    out = torch.empty(e, m, n, dtype=a.dtype, device=a.device)
    if out.numel() == 0 or k == 0:
        return out.zero_()
    bm, bn, bk = _blocks(m, n, path)
    rc = _build.library().repro_moe_gmm(
        a.data_ptr(), b.data_ptr(), out.data_ptr(), e, m, k, n, int(ta),
        int(tb), bm, bn, bk, _DTYPES[a.dtype], int(path == autotune.WGMMA),
        _build.stream_ptr(a))
    _build.check(rc, f"moe_gmm kernel launch ({path}, blocks {bm}x{bn}x{bk}"
                     f", ta {int(ta)}, tb {int(tb)})")
    _build.LAUNCHES["moe_gmm"] += 1
    return out


def moe_gmm(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """x [E, C, D] @ w [E, D, F] -> [E, C, F] in x's dtype (f32 or bf16,
    w of the same dtype).  No autograd (see :func:`grouped_matmul`)."""
    if x.dim() != 3 or w.dim() != 3 or x.shape[0] != w.shape[0] \
            or x.shape[2] != w.shape[1]:
        raise ValueError(f"moe_gmm: shapes {tuple(x.shape)} @ "
                         f"{tuple(w.shape)} are not [E, C, D] @ [E, D, F]")
    if _build.on_cpu("moe_gmm", x, w):
        return moe_gmm_ref(x, w)
    return _launch(x, w)


def moe_gmm_bwd(x: torch.Tensor, w: torch.Tensor, dy: torch.Tensor, *,
                need_dx: bool = True, need_dw: bool = True):
    """Gradients of :func:`moe_gmm` given dy [E, C, F]: (dx [E, C, D],
    dw [E, D, F]) in the inputs' dtype, each None when not needed; one
    kernel launch each, on x, w and dy as they lie (the tensor-core tile)
    or on transposed copies (the other tiles)."""
    dy = dy.contiguous()
    if _build.on_cpu("moe_gmm_bwd", x, w, dy):
        dx = moe_gmm_ref(dy, w.transpose(1, 2).contiguous()) \
            if need_dx else None
        dw = moe_gmm_ref(x.transpose(1, 2).contiguous(), dy) \
            if need_dw else None
        return dx, dw
    dx = _launch(dy, w, tb=True) if need_dx else None
    dw = _launch(x, dy, ta=True) if need_dw else None
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
