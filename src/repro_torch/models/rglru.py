"""The RG-LRU recurrence of ``repro.models.rglru`` on the training path
(:func:`rglru_scan`, the CUDA kernel on the card) and the causal
depthwise temporal convolution, which the SSD mixer borrows too."""
from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

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
