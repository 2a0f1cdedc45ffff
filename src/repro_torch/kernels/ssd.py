"""Mamba2 chunked SSD: the wrappers of the CUDA kernels ``csrc/ssd.cu``
(forward and backward) and the autograd Function of the SSD mixer.

Counterpart of ``repro.kernels.ssd.ssd`` (the training path's y) and,
for the prefill, of ``models/ssd.py`` ``ssd_chunked``'s final state
(:func:`ssd_prefill`; decode is ``models/ssd.ssd_step``): x [b, s, h, p],
dt [b, s, h] f32 (post-softplus), A_log [h] f32, B, C [b, s, n], D [h]
f32 -> y [b, s, h, p] in x's dtype.  The D skip is added in f32 before
the one cast to x's dtype, as the plain ``ssd_chunked`` does (the
JAX wrapper casts the kernel's output first and adds D after).  A CPU
tensor takes the plain versions (:func:`repro_torch.kernels.ref.ssd_ref`
and :func:`~repro_torch.kernels.ref.ssd_bwd_ref`); a CUDA tensor
launches the kernels or raises.

JAX has no backward kernel (XLA differentiates ``ssd_chunked``).  The
port's backward is a kernel of its own, :func:`ssd_bwd`: the chunked
backward of ``ssd_chunked`` (its plain version ``ssd_bwd_ref`` states
the algorithm), recomputing the forward's chunk states rather than
keeping them.
"""
from __future__ import annotations

import torch

from typing import Tuple

from repro_torch.kernels import _build
from repro_torch.kernels.ref import ssd_bwd_ref, ssd_chunked, ssd_ref

_DTYPES = {torch.float32: _build.DTYPE_F32, torch.bfloat16: _build.DTYPE_BF16}
MAX_CHUNK = 128          # the kernels' largest chunk
MAX_HEAD_DIM = 64        # the kernels' largest p
MAX_STATE = 128          # the kernels' largest n


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


def _check_kernel(tensors, chunk):
    """The kernels' dtypes, layout and sizes -> (b, s, h, p, n, q)."""
    x, dt, A_log, B, C, D = tensors[:6]
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
    if q > MAX_CHUNK or p > MAX_HEAD_DIM or n > MAX_STATE:
        raise ValueError(f"ssd kernel takes chunks up to {MAX_CHUNK}, head "
                         f"dims up to {MAX_HEAD_DIM} and states up to "
                         f"{MAX_STATE}, got {q}, {p} and {n}")
    return b, s, h, p, n, q


def _scratch(x, b, h, nc, p, n):
    """The forward's f32 scratch: C B^T of each chunk [b, nc, 128, 128]
    (causal, zero-padded), the chunk states [b, h, nc, p, n] and their
    decays [b, h, nc]."""
    f32 = dict(dtype=torch.float32, device=x.device)
    return (torch.empty(b, nc, MAX_CHUNK, MAX_CHUNK, **f32),
            torch.empty(b, h, nc, p, n, **f32), torch.empty(b, h, nc, **f32))


def _fwd(x, dt, A_log, B, C, D, chunk: int, final: bool):
    """The forward kernel's y and, with ``final``, the f32 state after
    the last step [b, h, p, n] (else None)."""
    b, s, h, p, n, q = _check_kernel((x, dt, A_log, B, C, D), chunk)
    y = torch.empty_like(x)
    cb, states, decay = _scratch(x, b, h, s // q, p, n)
    last = (torch.empty(b, h, p, n, dtype=torch.float32, device=x.device)
            if final else None)
    rc = _build.library().repro_ssd_fwd(
        x.data_ptr(), dt.data_ptr(), A_log.data_ptr(), B.data_ptr(),
        C.data_ptr(), D.data_ptr(), y.data_ptr(), cb.data_ptr(),
        states.data_ptr(), decay.data_ptr(),
        last.data_ptr() if final else None, b, s, h, p, n, q,
        _DTYPES[x.dtype], _build.stream_ptr(x))
    _build.check(rc, "ssd kernel launch")
    _build.LAUNCHES["ssd"] += 1
    return y, last


def ssd_fwd(x: torch.Tensor, dt: torch.Tensor, A_log: torch.Tensor,
            B: torch.Tensor, C: torch.Tensor, D: torch.Tensor, *,
            chunk: int = 128) -> torch.Tensor:
    """y of the chunked SSD (shapes in the module's docstring), chunk
    ``min(chunk, s)``.  No autograd (see :func:`ssd`)."""
    _check(x, dt, A_log, B, C, D, chunk)
    if _build.on_cpu("ssd", x, dt, A_log, B, C, D):
        return ssd_ref(x, dt, A_log, B, C, D, chunk=chunk)
    return _fwd(x, dt, A_log, B, C, D, chunk, False)[0]


def ssd_prefill(x: torch.Tensor, dt: torch.Tensor, A_log: torch.Tensor,
                B: torch.Tensor, C: torch.Tensor, D: torch.Tensor, *,
                chunk: int = 128) -> Tuple[torch.Tensor, torch.Tensor]:
    """``ssd_chunked``'s (y, final state [b, h, p, n] f32): the forward
    kernel with its scan's last carry written out (one launch), the plain
    ``ssd_chunked`` on the CPU.  No autograd."""
    _check(x, dt, A_log, B, C, D, chunk)
    if _build.on_cpu("ssd", x, dt, A_log, B, C, D):
        return ssd_chunked(x, dt, A_log, B, C, D, chunk=chunk)
    return _fwd(x, dt, A_log, B, C, D, chunk, True)


def ssd_bwd(x: torch.Tensor, dt: torch.Tensor, A_log: torch.Tensor,
            B: torch.Tensor, C: torch.Tensor, D: torch.Tensor,
            dy: torch.Tensor, *, chunk: int = 128):
    """Gradient of :func:`ssd_fwd` for the cotangent ``dy`` (x's shape and
    dtype): -> (dx, d(dt), dA_log, dB, dC, dD), each in its input's dtype,
    dB and dC summed over the heads."""
    _check(x, dt, A_log, B, C, D, chunk)
    if dy.shape != x.shape or dy.dtype != x.dtype:
        raise ValueError(f"ssd_bwd: dy {tuple(dy.shape)} {dy.dtype} is not "
                         f"like x {tuple(x.shape)} {x.dtype}")
    tensors = (x, dt, A_log, B, C, D, dy)
    if _build.on_cpu("ssd_bwd", *tensors):
        return ssd_bwd_ref(x, dt, A_log, B, C, D, dy, chunk=chunk)
    b, s, h, p, n, q = _check_kernel(tensors, chunk)
    nc = s // q
    cb, states, decay = _scratch(x, b, h, nc, p, n)
    f32 = dict(dtype=torch.float32, device=x.device)
    gstates = torch.empty_like(states)
    dcb_part = torch.empty(b, nc, h, q, q, **f32)
    dc_part = torch.empty(b, nc, h, q, n, **f32)
    db_part = torch.empty(b, nc, h, q, n, **f32)
    head_part = torch.empty(b, nc, h, 2, **f32)
    dx, dB, dC = (torch.empty_like(t) for t in (x, B, C))
    ddt, dA_log, dD = (torch.empty_like(t) for t in (dt, A_log, D))
    rc = _build.library().repro_ssd_bwd(
        x.data_ptr(), dt.data_ptr(), A_log.data_ptr(), B.data_ptr(),
        C.data_ptr(), D.data_ptr(), dy.data_ptr(), dx.data_ptr(),
        ddt.data_ptr(), dA_log.data_ptr(), dB.data_ptr(), dC.data_ptr(),
        dD.data_ptr(), cb.data_ptr(), states.data_ptr(), decay.data_ptr(),
        gstates.data_ptr(), dcb_part.data_ptr(), dc_part.data_ptr(),
        db_part.data_ptr(), head_part.data_ptr(), b, s, h, p, n, q,
        _DTYPES[x.dtype], _build.stream_ptr(x))
    _build.check(rc, "ssd_bwd kernel launch")
    _build.LAUNCHES["ssd_bwd"] += 1
    return dx, ddt, dA_log, dB, dC, dD


class SSDFunction(torch.autograd.Function):
    """Forward: the SSD kernel; backward: the SSD backward kernel (plain
    versions on the CPU).  Saves the inputs."""

    @staticmethod
    def forward(ctx, x, dt, A_log, B, C, D, chunk):
        ctx.save_for_backward(x, dt, A_log, B, C, D)
        ctx.chunk = chunk
        return ssd_fwd(x, dt, A_log, B, C, D, chunk=chunk)

    @staticmethod
    def backward(ctx, dy):
        need = ctx.needs_input_grad[:6]
        if not any(need):
            return (None,) * 7
        grads = ssd_bwd(*ctx.saved_tensors, dy.contiguous(), chunk=ctx.chunk)
        return (*(g if n else None for g, n in zip(grads, need)), None)


def ssd(x: torch.Tensor, dt: torch.Tensor, A_log: torch.Tensor,
        B: torch.Tensor, C: torch.Tensor, D: torch.Tensor, *,
        chunk: int = 128) -> torch.Tensor:
    """Differentiable chunked SSD (``repro.kernels.ssd.ssd``'s function);
    the inputs are made contiguous for the kernel."""
    return SSDFunction.apply(x.contiguous(), dt.contiguous(),
                             A_log.contiguous(), B.contiguous(),
                             C.contiguous(), D.contiguous(), chunk)
