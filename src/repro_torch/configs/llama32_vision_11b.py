"""llama-3.2-vision-11b — text backbone with cross-attn image layers every
5th layer. The vision tower is a STUB: input_specs() supplies precomputed
patch embeddings [hf:meta-llama/Llama-3.2-11B-Vision; unverified]."""
from repro_torch.configs.base import ArchConfig, CROSS_ATTN, GLOBAL_ATTN

CONFIG = ArchConfig(
    name="llama-3.2-vision-11b",
    family="vlm",
    num_layers=40,
    d_model=4096,
    num_heads=32,
    num_kv_heads=8,
    d_ff=14336,
    vocab_size=128256,
    head_dim=128,
    layer_pattern=(GLOBAL_ATTN, GLOBAL_ATTN, GLOBAL_ATTN, GLOBAL_ATTN, CROSS_ATTN),
    rope_theta=500_000.0,
    context_len=6404,                 # 4 tiles x 1601 patches (stubbed frontend)
    context_dim=4096,                 # already projected to d_model
    source="hf:meta-llama/Llama-3.2-11B-Vision; unverified",
)
