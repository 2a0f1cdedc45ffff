"""RMSNorm: wrapper of the CUDA kernel ``csrc/rmsnorm.cu``.

Counterpart of ``repro.kernels.rmsnorm.rmsnorm``.  A CPU tensor takes the
plain version (:func:`repro_torch.kernels.ref.rmsnorm_ref`); a CUDA
tensor launches the kernel or raises.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import _build
from repro_torch.kernels.ref import rmsnorm_ref

_DTYPES = {torch.float32: _build.DTYPE_F32, torch.bfloat16: _build.DTYPE_BF16}


def rmsnorm(x: torch.Tensor, scale: torch.Tensor, *,
            eps: float = 1e-5) -> torch.Tensor:
    """x [..., d] (f32 or bf16); scale [d] f32 -> [..., d] in x's dtype."""
    if x.device.type == "cpu" and scale.device.type == "cpu":
        return rmsnorm_ref(x, scale, eps)
    if x.device.type != "cuda" or scale.device != x.device:
        raise ValueError(
            f"rmsnorm: x on {x.device} and scale on {scale.device}; both "
            f"must be on the CPU or on the same CUDA device")
    if x.dtype not in _DTYPES:
        raise TypeError(f"rmsnorm kernel takes f32 or bf16 x, got {x.dtype}")
    d = x.shape[-1]
    if scale.dtype != torch.float32 or scale.shape != (d,):
        raise TypeError(
            f"rmsnorm kernel takes an f32 scale of shape ({d},), got "
            f"{scale.dtype} {tuple(scale.shape)}")
    if not (x.is_contiguous() and scale.is_contiguous()):
        raise ValueError("rmsnorm kernel takes contiguous x and scale")
    out = torch.empty_like(x)
    lib = _build.library()
    rc = lib.repro_rmsnorm(x.data_ptr(), scale.data_ptr(), out.data_ptr(),
                           x.numel() // d, d, eps, _DTYPES[x.dtype],
                           _build.stream_ptr(x))
    _build.check(rc, "rmsnorm kernel launch")
    _build.LAUNCHES["rmsnorm"] += 1
    return out
