"""The RG-LRU recurrence of ``repro.models.rglru``: the training path's
scan (:func:`rglru_scan`, the CUDA kernel on the card), the prefill's scan
with its f32 last state (:func:`rglru_prefill`, the same kernel), the
decode step (:func:`rglru_step`), and the causal depthwise temporal
convolution, which the SSD mixer borrows too."""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

from repro_torch.kernels import rglru as krglru
from repro_torch.kernels.ref import RGLRU_C, RGLRU_GATES
from repro_torch.kernels.rglru import rglru


def depthwise_conv1d(x: torch.Tensor, w: torch.Tensor,
                     state: Optional[torch.Tensor] = None
                     ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """Causal depthwise conv: x [b, s, W]; w [k, W] -> (y [b, s, W] in
    x's dtype, the last k-1 inputs [b, k-1, W] for decode).  ``state``
    [b, k-1, W] carries the previous call's last inputs (zeros when None).
    The taps are summed in JAX's order, in x's dtype."""
    k = w.shape[0]
    pad = (x.new_zeros(x.shape[0], k - 1, x.shape[2]) if state is None
           else state)
    xp = torch.cat([pad, x], dim=1)
    s = x.shape[1]
    y = torch.zeros_like(x)
    for i in range(k):
        y = y + xp[:, i:i + s] * w[i]
    return y, (xp[:, -(k - 1):] if k > 1 else None)


def rglru_scan(x: torch.Tensor, gates: Dict[str, torch.Tensor]
               ) -> torch.Tensor:
    """The training path's RG-LRU over the whole sequence from h = 0
    (``rglru_scan``'s y, without an initial state): x [b, s, W] (the conv'd
    branch), ``gates`` the five [W] f32 vectors -> y [b, s, W] in x's
    dtype, differentiable (:func:`repro_torch.kernels.rglru.rglru`)."""
    return rglru(x, gates)[0]


def rglru_prefill(x: torch.Tensor, gates: Dict[str, torch.Tensor]
                  ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``rglru_scan`` of the prefill: x [b, s, W] -> (y [b, s, W] in x's
    dtype, the f32 state of the last step [b, W], the decode's ``h``).  No
    autograd."""
    return krglru.rglru_prefill(
        x.contiguous(), tuple(gates[k].contiguous() for k in RGLRU_GATES))


def rglru_step(x: torch.Tensor, gates: Dict[str, torch.Tensor],
               h_prev: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """One decode step (``rglru_step``): x [b, 1, W]; h_prev [b, W] f32 ->
    (y [b, 1, W] in x's dtype, h [b, W] f32), the gates of ``_gates`` in
    f32, elementwise as JAX computes them in ``jnp``."""
    xf = x[:, 0].float()
    r = torch.sigmoid(xf * gates["w_a"] + gates["b_a"])
    i = torch.sigmoid(xf * gates["w_x"] + gates["b_x"])
    log_a = -RGLRU_C * torch.nn.functional.softplus(gates["a_param"]) * r
    gated = torch.sqrt(torch.clamp_min(1.0 - torch.exp(2.0 * log_a), 1e-6)) \
        * (i * xf)
    h = torch.exp(log_a) * h_prev + gated
    return h[:, None].to(x.dtype), h
