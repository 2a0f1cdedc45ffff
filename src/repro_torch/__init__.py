"""PyTorch / CUDA port of the Oases reproduction for NVIDIA Hopper (H100).

The JAX package ``repro`` is the reference; this package mirrors its
layout (``configs``, ``core``, ``models``, ``kernels``, ``serving``,
``launch``) and imports nothing from it.  The first slice is the paged-KV
serving path: the decode step of ``repro.models.lm.build_decode`` with
hand-written CUDA kernels for paged decode attention and RMSNorm.
"""
