"""Mamba2 SSD (state-space duality), plain PyTorch (``repro.models.ssd``).

:func:`ssd_chunked` is the chunked algorithm of the Mamba2 paper (an
intra-chunk quadratic term and an inter-chunk recurrence over chunk
states), with one group of B and C shared by every head; the training
path and the prefill run its CUDA kernels (:mod:`repro_torch.kernels.ssd`,
forward and backward; the prefill's forward also writes the final
state).  :func:`ssd_sequential` is the O(s) recurrence, the oracle.
Both are the SSD kernel's plain versions and live with the other plain
versions in :mod:`repro_torch.kernels.ref`, beside the backward's,
``ssd_bwd_ref``.  :func:`ssd_step` is the decode step: one step is
elementwise work and a state-sized product, computed in torch as JAX
computes it in ``jnp``.
"""
from typing import Tuple

import torch

from repro_torch.kernels.ref import ssd_chunked, ssd_sequential

__all__ = ["ssd_chunked", "ssd_sequential", "ssd_step"]


def ssd_step(x: torch.Tensor, dt: torch.Tensor, A_log: torch.Tensor,
             B: torch.Tensor, C: torch.Tensor, D: torch.Tensor,
             S: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """One step (``repro.models.ssd.ssd_step``): x [b, h, p]; dt [b, h]
    (post-softplus); A_log, D [h]; B, C [b, n]; S [b, h, p, n] f32 ->
    (y [b, h, p] in x's dtype, the new f32 state).  ``S' = exp(-exp(A_log)
    dt) S + (dt x) B^T`` and ``y = S' C + D x``, in f32."""
    a = -torch.exp(A_log.float())
    xf = x.float()
    dtf = dt.float()
    decay = torch.exp(dtf * a[None, :])
    S = S * decay[..., None, None] + (xf * dtf[..., None])[..., None] \
        * B.float()[:, None, None, :]
    y = torch.einsum("bhpn,bn->bhp", S, C.float())
    y = y + D.float()[None, :, None] * xf
    return y.to(x.dtype), S
