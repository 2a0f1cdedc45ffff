"""RMSNorm: wrappers of the CUDA kernels ``csrc/rmsnorm.cu`` and the
autograd Function that joins them.

Counterpart of ``repro.kernels.rmsnorm.rmsnorm``.  A CPU tensor takes the
plain versions (:func:`repro_torch.kernels.ref.rmsnorm_ref` and
:func:`~repro_torch.kernels.ref.rmsnorm_bwd_ref`); a CUDA tensor launches
the kernels or raises.  The kernels are called through ``ctypes``, which
autograd cannot see, so :func:`rmsnorm` wraps both directions in one
``torch.autograd.Function`` on every device.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.ref import rmsnorm_bwd_ref, rmsnorm_ref

_DTYPES = {torch.float32: _build.DTYPE_F32, torch.bfloat16: _build.DTYPE_BF16}
# blocks of the backward's first pass, one per SM of an H100 (two blocks
# of 16 warps at the ~82 registers a thread that ptxas gives the kernel
# exceed an SM's 65,536, so more blocks would run as a second wave): each
# adds its rows into one f32 row of the [blocks, d] dscale scratch
BWD_BLOCKS = 132
# the backward's block: 16 warps, a thread holding 8 columns of a row
BWD_WARPS = 16
BWD_COLS = 8
# per (device, stream): the backward's f32 dscale partials, grown to the
# largest call seen
_BWD_SCRATCH = {}


def bwd_geometry(rows: int, d: int):
    """(warps a row, rows a block, blocks) of the backward kernel: a row
    of d <= 4096 is held by ceil(d / 256) warps, 8 columns a thread, and a
    block of at most 16 warps takes as many such groups as fit; wider rows
    take a whole block each."""
    wpr = min(-(-d // (32 * BWD_COLS)), BWD_WARPS)
    rpb = BWD_WARPS // wpr
    return wpr, rpb, min(-(-rows // rpb), BWD_BLOCKS)


# the forward: a thread holds FWD_VECS 16-byte words of a row (bf16 8
# columns a word, f32 4), a block FWD_WARPS warps
FWD_VECS = 2
FWD_WARPS = 16


def fwd_geometry(rows: int, d: int, elt: int = 2):
    """(warps a row, rows a block, blocks) of the forward kernel for
    ``elt``-byte values: a row of d <= 4096 is held by ceil(d / (32 x
    FWD_VECS x 16 / elt)) warps, a block of 16 warps takes as many such
    rows as fit, and there is a block for every that many rows; wider rows
    take the backward's 16-warp block a row (:func:`bwd_geometry`)."""
    if d > BWD_WARPS * 32 * BWD_COLS:
        return bwd_geometry(rows, d)
    wpr = -(-d // (32 * FWD_VECS * 16 // elt))
    rpb = FWD_WARPS // wpr
    return wpr, rpb, -(-rows // rpb)


def _bwd_partial(device, stream: int, floats: int) -> torch.Tensor:
    buf = _BWD_SCRATCH.get((device, stream))
    if buf is None or buf.numel() < floats:
        buf = torch.empty(floats, dtype=torch.float32, device=device)
        _BWD_SCRATCH[device, stream] = buf
    return buf


def _check(x: torch.Tensor, scale: torch.Tensor):
    if x.dtype not in _DTYPES:
        raise TypeError(f"rmsnorm kernel takes f32 or bf16 x, got {x.dtype}")
    d = x.shape[-1]
    if scale.dtype != torch.float32 or scale.shape != (d,):
        raise TypeError(
            f"rmsnorm kernel takes an f32 scale of shape ({d},), got "
            f"{scale.dtype} {tuple(scale.shape)}")
    if not (x.is_contiguous() and scale.is_contiguous()):
        raise ValueError("rmsnorm kernel takes contiguous x and scale")


def rmsnorm_fwd(x: torch.Tensor, scale: torch.Tensor, *,
                eps: float = 1e-5) -> torch.Tensor:
    """x [..., d] (f32 or bf16); scale [d] f32 -> [..., d] in x's dtype.
    No autograd (see :func:`rmsnorm`)."""
    if _build.on_cpu("rmsnorm", x, scale):
        return rmsnorm_ref(x, scale, eps)
    _check(x, scale)
    d = x.shape[-1]
    rows = x.numel() // d
    out = torch.empty_like(x)
    if rows == 0:
        return out
    wpr, rpb, nblocks = fwd_geometry(rows, d, x.element_size())
    lib = _build.library()
    rc = lib.repro_rmsnorm(x.data_ptr(), scale.data_ptr(), out.data_ptr(),
                           rows, d, wpr, rpb, nblocks, eps, _DTYPES[x.dtype],
                           _build.stream_ptr(x))
    _build.check(rc, "rmsnorm kernel launch")
    _build.LAUNCHES["rmsnorm"] += 1
    return out


def rmsnorm_bwd(x: torch.Tensor, scale: torch.Tensor, dy: torch.Tensor, *,
                eps: float = 1e-5):
    """Gradient of :func:`rmsnorm_fwd`: -> (dx in x's dtype, dscale [d]
    f32).  dy has x's shape and dtype."""
    if _build.on_cpu("rmsnorm_bwd", x, scale, dy):
        return rmsnorm_bwd_ref(x, scale, dy, eps)
    _check(x, scale)
    if dy.shape != x.shape or dy.dtype != x.dtype or not dy.is_contiguous():
        raise ValueError(
            f"rmsnorm_bwd kernel takes a contiguous dy like x "
            f"{tuple(x.shape)} {x.dtype}, got {tuple(dy.shape)} {dy.dtype}")
    d = x.shape[-1]
    rows = x.numel() // d
    dx = torch.empty_like(x)
    if rows == 0:
        return dx, torch.zeros_like(scale)
    wpr, rpb, nblocks = bwd_geometry(rows, d)
    stream = _build.stream_ptr(x)
    partial = _bwd_partial(x.device, stream, nblocks * d)
    dscale = torch.empty_like(scale)
    lib = _build.library()
    rc = lib.repro_rmsnorm_bwd(x.data_ptr(), scale.data_ptr(), dy.data_ptr(),
                               dx.data_ptr(), dscale.data_ptr(),
                               partial.data_ptr(), rows, d, wpr, rpb, nblocks,
                               eps, _DTYPES[x.dtype], stream)
    _build.check(rc, "rmsnorm_bwd kernel launch")
    _build.LAUNCHES["rmsnorm_bwd"] += 1
    return dx, dscale


class RMSNormFunction(torch.autograd.Function):
    """Forward: the RMSNorm kernel (plain version on the CPU); backward:
    the backward kernel.  Saves x and scale; r is recomputed."""

    @staticmethod
    def forward(ctx, x, scale, eps):
        ctx.save_for_backward(x, scale)
        ctx.eps = eps
        return rmsnorm_fwd(x, scale, eps=eps)

    @staticmethod
    def backward(ctx, dy):
        x, scale = ctx.saved_tensors
        dx, dscale = rmsnorm_bwd(x, scale, dy.contiguous(), eps=ctx.eps)
        return dx, dscale, None


def rmsnorm(x: torch.Tensor, scale: torch.Tensor, *,
            eps: float = 1e-5) -> torch.Tensor:
    """x [..., d] (f32 or bf16); scale [d] f32 -> [..., d] in x's dtype,
    differentiable in x and scale."""
    return RMSNormFunction.apply(x, scale, eps)
