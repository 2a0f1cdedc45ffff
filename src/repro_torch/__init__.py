"""PyTorch / CUDA port of the Oases reproduction for NVIDIA Hopper (H100).

The JAX package ``repro`` is the reference; this package mirrors its
layout (``configs``, ``core``, ``models``, ``kernels``, ``serving``,
``optim``, ``data``, ``runtime``, ``launch``) and imports nothing from
it.  The first slice is the paged-KV serving path: the decode step of
``repro.models.lm.build_decode`` with hand-written CUDA kernels for paged
decode attention and RMSNorm.  The second is training on one device:
``build_train_loss`` at tp=1, AdamW and the trainer, with hand-written
CUDA kernels for flash attention forward and backward and the RMSNorm
backward.  The third is 1-D tensor model parallelism: the paper's
schedules and recomputation over a communicator of rank processes, with
hand-written kernels for the tile matmul, the fused matmul ->
reduce-scatter ring and the collectives between the ranks.  The fourth
adds sequence parallelism and ring attention, the fifth the Mamba2 SSD
and MoE families, the sixth the RG-LRU hybrid (recurrentgemma-9b), each
with hand-written kernels for what the TPU kernels computed.
"""
