"""Mamba2 chunked SSD: the wrapper of the CUDA kernel ``csrc/ssd.cu`` and
the autograd Function of the SSD mixer.

Counterpart of ``repro.kernels.ssd.ssd`` (the training path's y; the
final state is not returned, decode is ``ssd_step``): x [b, s, h, p],
dt [b, s, h] f32 (post-softplus), A_log [h] f32, B, C [b, s, n], D [h]
f32 -> y [b, s, h, p] in x's dtype.  The D skip is added in f32 before
the one cast to x's dtype, as the plain ``ssd_chunked`` does (the
JAX wrapper casts the kernel's output first and adds D after).  A CPU
tensor takes the plain version (:func:`repro_torch.kernels.ref.ssd_ref`);
a CUDA tensor launches the kernel or raises.

JAX has no backward kernel (XLA differentiates ``ssd_chunked``).  The
Function's backward replays the plain ``ssd_chunked`` under autograd, in
torch ops, on every device (as the ring-attention backward does).
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.ref import ssd_chunked, ssd_ref

_DTYPES = {torch.float32: _build.DTYPE_F32, torch.bfloat16: _build.DTYPE_BF16}
MAX_CHUNK = 128          # the kernel's largest chunk
MAX_HEAD_DIM = 128       # the kernel's largest p


def _check(x, dt, A_log, B, C, D, chunk):
    if x.dim() != 4 or dt.shape != x.shape[:3] or B.dim() != 3 \
            or B.shape[:2] != x.shape[:2] or C.shape != B.shape \
            or A_log.shape != (x.shape[2],) or D.shape != (x.shape[2],):
        raise ValueError(
            f"ssd: x {tuple(x.shape)}, dt {tuple(dt.shape)}, A_log "
            f"{tuple(A_log.shape)}, B {tuple(B.shape)}, C {tuple(C.shape)}, "
            f"D {tuple(D.shape)} do not match [b, s, h, p], [b, s, h], [h], "
            f"[b, s, n], [b, s, n], [h]")
    s = x.shape[1]
    if chunk < 1 or s % min(chunk, s):
        raise ValueError(f"ssd: seq {s} must divide by chunk {min(chunk, s)}")


def ssd_fwd(x: torch.Tensor, dt: torch.Tensor, A_log: torch.Tensor,
            B: torch.Tensor, C: torch.Tensor, D: torch.Tensor, *,
            chunk: int = 128) -> torch.Tensor:
    """y of the chunked SSD (shapes in the module's docstring), chunk
    ``min(chunk, s)``.  No autograd (see :func:`ssd`)."""
    _check(x, dt, A_log, B, C, D, chunk)
    tensors = (x, dt, A_log, B, C, D)
    if _build.on_cpu("ssd", *tensors):
        return ssd_ref(x, dt, A_log, B, C, D, chunk=chunk)
    if x.dtype not in _DTYPES or B.dtype != x.dtype or C.dtype != x.dtype:
        raise TypeError(f"ssd kernel takes f32 or bf16 x, B, C of one dtype, "
                        f"got {x.dtype}, {B.dtype}, {C.dtype}")
    if any(t.dtype != torch.float32 for t in (dt, A_log, D)):
        raise TypeError(f"ssd kernel takes f32 dt, A_log and D, got "
                        f"{dt.dtype}, {A_log.dtype}, {D.dtype}")
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("ssd kernel takes contiguous tensors")
    b, s, h, p = x.shape
    n = B.shape[2]
    q = min(chunk, s)
    if q > MAX_CHUNK or p > MAX_HEAD_DIM:
        raise ValueError(f"ssd kernel takes chunks up to {MAX_CHUNK} and "
                         f"head dims up to {MAX_HEAD_DIM}, got {q} and {p}")
    nc = s // q
    y = torch.empty_like(x)
    states = torch.empty(b, h, nc, p, n, dtype=torch.float32,
                         device=x.device)
    decay = torch.empty(b, h, nc, dtype=torch.float32, device=x.device)
    rc = _build.library().repro_ssd_fwd(
        x.data_ptr(), dt.data_ptr(), A_log.data_ptr(), B.data_ptr(),
        C.data_ptr(), D.data_ptr(), y.data_ptr(), states.data_ptr(),
        decay.data_ptr(), b, s, h, p, n, q, _DTYPES[x.dtype],
        _build.stream_ptr(x))
    _build.check(rc, "ssd kernel launch")
    _build.LAUNCHES["ssd"] += 1
    return y


class SSDFunction(torch.autograd.Function):
    """Forward: the SSD kernel (plain version on the CPU); backward: the
    plain ``ssd_chunked`` replayed under autograd.  Saves the inputs."""

    @staticmethod
    def forward(ctx, x, dt, A_log, B, C, D, chunk):
        ctx.save_for_backward(x, dt, A_log, B, C, D)
        ctx.chunk = chunk
        return ssd_fwd(x, dt, A_log, B, C, D, chunk=chunk)

    @staticmethod
    def backward(ctx, dy):
        need = ctx.needs_input_grad[:6]
        ins = [t.detach().requires_grad_(g)
               for t, g in zip(ctx.saved_tensors, need)]
        with torch.enable_grad():
            y, _ = ssd_chunked(*ins, chunk=ctx.chunk)
        wrt = [t for t, g in zip(ins, need) if g]
        got = iter(torch.autograd.grad(y, wrt, dy) if wrt else ())
        return (*(next(got) if g else None for g in need), None)


def ssd(x: torch.Tensor, dt: torch.Tensor, A_log: torch.Tensor,
        B: torch.Tensor, C: torch.Tensor, D: torch.Tensor, *,
        chunk: int = 128) -> torch.Tensor:
    """Differentiable chunked SSD (``repro.kernels.ssd.ssd``'s function);
    the inputs are made contiguous for the kernel."""
    return SSDFunction.apply(x.contiguous(), dt.contiguous(),
                             A_log.contiguous(), B.contiguous(),
                             C.contiguous(), D.contiguous(), chunk)
