"""Mamba2 SSD (state-space duality), plain PyTorch (``repro.models.ssd``).

:func:`ssd_chunked` is the chunked algorithm of the Mamba2 paper (an
intra-chunk quadratic term and an inter-chunk recurrence over chunk
states), with one group of B and C shared by every head; the training
path runs its CUDA kernels (:mod:`repro_torch.kernels.ssd`, forward and
backward).  :func:`ssd_sequential` is the O(s) recurrence, the oracle.
Both are the SSD kernel's plain versions and live with the other plain
versions in :mod:`repro_torch.kernels.ref`, beside the backward's,
``ssd_bwd_ref``.
"""
from repro_torch.kernels.ref import ssd_chunked, ssd_sequential

__all__ = ["ssd_chunked", "ssd_sequential"]
